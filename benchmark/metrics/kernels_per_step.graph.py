"""Device kernels a training step of the graph cells, counted from the trace of
the traced calls (graph replays included, copies and sets not)."""

from harness import readouts

UNIT = "kernels"
read = readouts.kernels_per_step
