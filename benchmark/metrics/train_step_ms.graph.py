"""Milliseconds a training step of the graph cells: the window's host-clock
seconds, ended by a synchronize, over the optimizer steps its calls took."""

from harness import readouts

UNIT = "ms"
read = readouts.step_ms
