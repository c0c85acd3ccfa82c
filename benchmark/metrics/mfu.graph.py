"""The whole training step's share of the card's peak in the graph cells: three
times the forward operations of both nets over the host-clock time a step of
the untraced calls after the traced span, times the dense bf16 peak, in
percent."""

from harness import readouts

UNIT = "%"
read = readouts.mfu_steps
