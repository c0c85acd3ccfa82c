"""The 4x256 proposal MLP's least time over its two rounds of the traced
frames over the traced time of its dense-layer kernels (K11, linear_kernel
epilogue 5: the proposal MLP in one launch), in percent."""

from harness import readouts_m360

UNIT = "%"
read = readouts_m360.prop_mlp_roofline
