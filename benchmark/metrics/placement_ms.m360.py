"""Host milliseconds a traced mip-NeRF 360 frame spends in the program's
m360.placement spans (max-dilation, the inverse CDF and the intervals, K12,
before each level)."""

from harness import readouts_m360

UNIT = "ms"
read = readouts_m360.placement_ms
