"""The whole frame's share of the card's peak in the mip-NeRF 360 click cell:
the operations both proposal rounds and the NeRF MLP need over every sample
of the traced frames, over their host-clock span in the trace times the dense
bf16 peak, in percent."""

from harness import readouts_m360

UNIT = "%"
read = readouts_m360.mfu
