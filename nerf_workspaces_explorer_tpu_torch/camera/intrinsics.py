"""Pinhole camera intrinsics.

Counterpart of `nerf_workspaces_explorer_tpu/camera/intrinsics.py`
(reference nerf/inference/nerf_replica_inference_handler.py:67-74: fx =
W / 2 / tan(hfov / 2) with fx == fy, the principal point at the pixel
grid's centre (W - 1) / 2, (H - 1) / 2, hfov 90 degrees by default).
"""

from __future__ import annotations

import math
from typing import NamedTuple


class PinholeIntrinsics(NamedTuple):
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_hfov(cls, height: int, width: int, hfov_degrees: float = 90.0) -> "PinholeIntrinsics":
        fx = width / 2.0 / math.tan(math.radians(hfov_degrees / 2.0))
        return cls(height=height, width=width, fx=fx, fy=fx, cx=(width - 1.0) / 2.0, cy=(height - 1.0) / 2.0)
