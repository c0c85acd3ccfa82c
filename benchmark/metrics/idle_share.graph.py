"""The device's idle share of a training step of the graph cells: 1 - the busy
time a traced step over the host-clock time a step of the untraced calls
after the traced span, in percent."""

from harness import readouts

UNIT = "%"
read = readouts.idle_share_steps
