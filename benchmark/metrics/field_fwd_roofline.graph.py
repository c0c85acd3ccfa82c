"""The training field's forward kernel's (K4) share of its roofline in the
graph cells: the least time for a step's forward of both nets, times the
traced steps, over the kernel's traced time, in percent."""

from harness import readouts

UNIT = "%"
read = readouts.field_fwd_roofline
