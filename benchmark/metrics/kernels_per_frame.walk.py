"""Device kernels a traced frame of the walk cells, counted from the trace
(graph replays included, copies and sets not)."""

from harness import readouts

UNIT = "kernels"
read = readouts.kernels_per_frame
