"""Milliseconds a frame of the click cells: the window's host-clock seconds
over the frames served in it, each ending as the uint8 frame on the host."""

from harness import readouts

UNIT = "ms"
read = readouts.frame_ms
