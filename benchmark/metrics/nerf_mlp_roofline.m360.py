"""The 8x1024 NeRF MLP's least time over the traced frames
(harness/counts_m360.py) over the traced time of its dense-layer kernels
(K11, linear_kernel epilogues 0, 1, 3, 4), in percent."""

from harness import readouts_m360

UNIT = "%"
read = readouts_m360.nerf_mlp_roofline
