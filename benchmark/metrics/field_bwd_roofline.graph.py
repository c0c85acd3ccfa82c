"""The training field's backward's (K5: chain, dW and row sums) share of its
roofline in the graph cells: twice the forward's operations at the peak,
times the traced steps, over the summed traced time of K5's kernels, in
percent."""

from harness import readouts

UNIT = "%"
read = readouts.field_bwd_roofline
