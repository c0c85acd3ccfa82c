"""Numerical debugging: the reference's NaN/Inf scan of rendered outputs.

Counterpart of `nerf_workspaces_explorer_tpu/obs/debug.py`: a per-key
finite-scan that prints as the reference does
(nerf/inference/nerf_replica_inference_handler.py:273-276), and the
reference's autograd anomaly detection (nerf/models/nerf_model.py:7), here
opt-in rather than set globally at import.
"""

from __future__ import annotations

from typing import Any, List, Mapping

import numpy as np
import torch


def enable_nan_debugging(enabled: bool = True) -> None:
    """Raise in backward on the first NaN an autograd function produces
    (`torch.autograd.set_detect_anomaly`). Opt-in: it slows every step."""
    torch.autograd.set_detect_anomaly(enabled)


def scan_outputs_finite(outputs: Mapping[str, Any], *, raise_on_error: bool = False) -> List[str]:
    """Check every output (tensor on any device, or array) for NaN/Inf;
    print the reference's message for each offending key and return them."""
    bad: List[str] = []
    for key, value in outputs.items():
        if value is None:
            continue
        finite = bool(torch.isfinite(value).all()) if isinstance(value, torch.Tensor) else bool(
            np.all(np.isfinite(np.asarray(value))))
        if not finite:
            bad.append(key)
            print(f"[Numerical Error] {key} contains NaN or inf.")
    if bad and raise_on_error:
        raise FloatingPointError(f"non-finite outputs: {bad}")
    return bad
