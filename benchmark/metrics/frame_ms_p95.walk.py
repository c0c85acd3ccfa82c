"""The 95th percentile of every frame's host-clock latency in the window of the
walk cells."""

from harness import readouts

UNIT = "ms"
read = readouts.frame_ms_p95
