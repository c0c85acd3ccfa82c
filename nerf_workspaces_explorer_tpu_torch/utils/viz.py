"""Visualization helpers (depth colorization); a copy of
`nerf_workspaces_explorer_tpu/utils/viz.py`.

Replaces the reference's `imgviz.depth2rgb` dependency (reference
nerf/training/nerf_replica_training_handler.py:139-141) with a small
colormap implementation so the framework has no imgviz requirement.
"""

from __future__ import annotations

import numpy as np

# 9-stop approximation of the "turbo" colormap.
_TURBO_STOPS = np.array(
    [
        [0.190, 0.072, 0.232],
        [0.276, 0.407, 0.976],
        [0.150, 0.735, 0.843],
        [0.254, 0.937, 0.414],
        [0.711, 0.973, 0.217],
        [0.977, 0.730, 0.224],
        [0.954, 0.434, 0.130],
        [0.739, 0.150, 0.028],
        [0.480, 0.016, 0.011],
    ],
    dtype=np.float64,
)


def depth2rgb(
    depth: np.ndarray, min_value: float | None = None, max_value: float | None = None
) -> np.ndarray:
    """Colorize a depth map [H, W] -> uint8 [H, W, 3]."""
    depth = np.asarray(depth, dtype=np.float64)
    lo = float(np.nanmin(depth)) if min_value is None else float(min_value)
    hi = float(np.nanmax(depth)) if max_value is None else float(max_value)
    span = hi - lo if hi > lo else 1.0
    t = np.clip((depth - lo) / span, 0.0, 1.0)

    positions = t * (len(_TURBO_STOPS) - 1)
    low_idx = np.clip(positions.astype(np.int64), 0, len(_TURBO_STOPS) - 2)
    frac = positions - low_idx
    rgb = (
        _TURBO_STOPS[low_idx] * (1.0 - frac[..., None])
        + _TURBO_STOPS[low_idx + 1] * frac[..., None]
    )
    return (rgb * 255.0).astype(np.uint8)
