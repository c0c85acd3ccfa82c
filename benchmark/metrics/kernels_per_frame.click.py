"""Device kernels a traced frame of the click cells, counted from the trace
(graph replays included, copies and sets not)."""

from harness import readouts

UNIT = "kernels"
read = readouts.kernels_per_frame
