"""Readers of the turbo preset's distilled-student sidecar.

Counterpart of the readers in `nerf_workspaces_explorer_tpu/train/distill.py`
(:59-101, :422-439). A turbo sidecar (`model.turbo.npz` beside `model.npz`)
holds a narrow proposal-mode student distilled from the checkpoint, and its
metadata names the student's architecture and the serving settings it was
gated at (importance samples, proposal frequencies, placement stride).
Distillation itself is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint
from nerf_workspaces_explorer_tpu_torch.models.encoding import embedding_output_dim
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec

TURBO_SUFFIX = ".turbo.npz"

# The default student: 6x192 at a 10-frequency encoding, the architecture
# that holds interior scenes.
DEFAULT_STUDENT = {"depth": 6, "width": 192, "num_freqs_3d": 10}


def turbo_sidecar_path(ckpt_path: str) -> str:
    """`model.ckpt` / `model.npz` -> `model.turbo.npz` (same directory)."""
    stem, _ = os.path.splitext(ckpt_path)
    return stem + TURBO_SUFFIX


def student_spec_from_meta(meta: Dict[str, Any]) -> Tuple[NerfMLPSpec, Dict[str, Any]]:
    """The student's NerfMLPSpec and its metadata entry."""
    student = meta["student"]
    spec = NerfMLPSpec(
        depth=int(student["depth"]),
        width=int(student["width"]),
        input_ch=embedding_output_dim(int(student["num_freqs_3d"])),
        input_ch_views=embedding_output_dim(int(student.get("num_freqs_2d", 4))),
        use_view_dirs=True,
    )
    return spec, student


def load_turbo_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A sidecar -> (params tree of numpy arrays, metadata). Raises if the
    file is not a turbo checkpoint."""
    params, _, meta = load_checkpoint(path)
    if not meta.get("turbo"):
        raise ValueError(f"{path} is not a turbo (distilled-student) checkpoint")
    return params, meta


def read_turbo_metadata(path: str) -> Dict[str, Any]:
    """The sidecar's metadata alone (the renderer's settings come from it
    before any weights load)."""
    with np.load(path) as arrays:
        meta = json.loads(bytes(arrays["__meta__"].tobytes()).decode())
    if not meta.get("turbo"):
        raise ValueError(f"{path} is not a turbo (distilled-student) checkpoint")
    return meta
