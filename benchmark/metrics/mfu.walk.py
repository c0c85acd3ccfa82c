"""The whole frame's share of the card's peak in the walk cells: the operations
the traced frames' inputs need over their host-clock span in the trace times
the dense bf16 peak, in percent."""

from harness import readouts

UNIT = "%"
read = readouts.mfu_frames
