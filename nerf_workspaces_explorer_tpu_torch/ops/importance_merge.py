"""Importance sampling (+ coarse/fine depth merge) of the fused inference path.

Counterpart of `nerf_workspaces_explorer_tpu/ops/pallas_sampling.py`
(`importance_merge_pallas`). Per ray: bins = midpoints of the S coarse
depths, pdf = normalised `w[1:-1] + 1e-5`, deterministic quantiles
u = linspace(0, 1, I), inverse CDF with the reference's guards; then, with
merge=True (the reference preset), the sorted union with the coarse depths,
or, with merge=False (the fast and turbo presets), the I ascending samples
alone.

`importance_merge` launches the CUDA kernel `csrc/importance_merge.cu` for a
CUDA tensor (K2 merged, K6 importance-only) and runs `importance_merge_plain`
for a CPU tensor. The kernel stages a tile of 32 rays in shared memory, a
lane each, and splits each ray's work over the block's warps: the CDF by
segments, the quantiles each by its own binary search, the merge by ranks
through a shared output tile written in whole rows (K6 stores its rows
straight from registers); its note says why. It differs from the plain
version only in rounding: the CDF's summation order (cumulative sums divided
by the total), a reciprocal in the interpolation, and the clamp of each
sample to its bin's upper edge (an ulp at most), which makes every output
column ascending.
"""

from __future__ import annotations

import torch

from nerf_workspaces_explorer_tpu_torch.ops import _build
from nerf_workspaces_explorer_tpu_torch.rays.sampling import merge_sorted_z, sample_pdf

# Kernel launches made by `importance_merge`: merged (K2) and
# importance-only (K6).
LAUNCHES = {"importance_merge": 0, "importance_only": 0}


def importance_merge_plain(
    weights_t: torch.Tensor, z_t: torch.Tensor, n_importance: int, merge: bool = True
) -> torch.Tensor:
    """[S, R] coarse weights and depths -> [S + I, R] merged depths,
    `merge_sorted_z(z, sample_pdf(z_mid, w[1:-1], I))` per ray, or with
    merge=False the [I, R] samples `sample_pdf(z_mid, w[1:-1], I)`."""
    z, w = z_t.T, weights_t.T
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    samples = sample_pdf(z_mid, w[:, 1:-1], n_importance)
    if not merge:
        return samples.T.contiguous()
    return merge_sorted_z(z, samples).T.contiguous()


def _importance_merge_cuda(
    weights_t: torch.Tensor, z_t: torch.Tensor, n_importance: int, merge: bool
) -> torch.Tensor:
    s, r = z_t.shape
    if z_t.device.type != "cuda":
        raise ValueError(f"no importance kernel for device {z_t.device}")
    if not 3 <= s <= 256:
        raise ValueError(f"the importance kernel takes 3..256 coarse samples, got {s}")
    for name, t in (("weights_t", weights_t), ("z_t", z_t)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != z_t.device:
            raise ValueError(f"{name} must be contiguous float32 on {z_t.device}")
    out_rows = s + n_importance if merge else n_importance
    out = torch.empty((out_rows, r), dtype=torch.float32, device=z_t.device)
    _build.launch(
        "importance_merge", "importance_merge_launch",
        weights_t.data_ptr(), z_t.data_ptr(), out.data_ptr(), r, s, n_importance, int(merge),
        _build.stream_handle(z_t.device),
    )
    LAUNCHES["importance_merge" if merge else "importance_only"] += 1
    return out


def empty_launch(device: torch.device) -> None:
    """One launch of an empty kernel through this module's library, on the
    current stream: the floor under any launch of the placement kernel,
    which `chip_smoke.py` times the same way beside it."""
    _build.launch("importance_merge", "importance_empty_launch", _build.stream_handle(device))


def importance_merge(
    weights_t: torch.Tensor, z_t: torch.Tensor, n_importance: int, merge: bool = True
) -> torch.Tensor:
    """weights_t, z_t: [S, R] (rays on the last axis). Returns the per-ray
    sorted union of the coarse depths and the I deterministic inverse-CDF
    samples, [S + I, R], or with merge=False the I samples alone, [I, R]
    (ascending); either equal to `importance_merge_plain` up to the fp32
    rounding of the CDF and the interpolation (see the module's note)."""
    if n_importance < 2:
        raise ValueError(
            "importance_merge needs n_importance >= 2 (deterministic quantiles "
            "are linspace(0, 1, n_importance))"
        )
    if weights_t.shape != z_t.shape or z_t.ndim != 2:
        raise ValueError(f"weights_t {tuple(weights_t.shape)} and z_t {tuple(z_t.shape)} must be one [S, R] shape")
    if z_t.device.type == "cpu":
        return importance_merge_plain(weights_t, z_t, n_importance, merge)
    return _importance_merge_cuda(weights_t, z_t, n_importance, merge)
