"""Numbers by which served uint8 frames are held against the reference's."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

def gaps(served, ref: np.ndarray) -> np.ndarray:
    """served - ref in uint8 levels, float64 (frames or pixel samples [..., 3]);
    a missing or misshapen answer reads 255 everywhere."""
    if served is None or served.shape != ref.shape or served.dtype != np.uint8:
        return np.full(ref.shape, 255.0)
    return (served.astype(np.int32) - ref.astype(np.int32)).astype(np.float64)


def sample_numbers(per_frame_gaps: List[np.ndarray]) -> Dict[str, float]:
    """Over all values compared: the mean absolute gap, each frame's
    absolute mean signed gap (its brightness shift) averaged over the
    frames, the share (%) of values 2 or more levels apart; the worst
    frame's mean absolute gap and the largest single gap."""
    if not per_frame_gaps:
        return {}
    d = np.abs(np.concatenate([g.reshape(-1) for g in per_frame_gaps]))
    return {
        "mean_abs": float(d.mean()),
        "mean_frame_abs_bias": float(np.mean([abs(g.mean()) for g in per_frame_gaps])),
        "share_ge2": float((d >= 2).mean() * 100.0),
        "worst_frame_mean_abs": float(max(np.abs(g).mean() for g in per_frame_gaps)),
        "max_abs": float(d.max()),
    }
