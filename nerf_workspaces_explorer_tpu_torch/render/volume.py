"""Volume rendering compositing: raw network outputs -> per-ray maps.

Counterpart of `nerf_workspaces_explorer_tpu/render/volume.py` (reference
nerf/models/model_utils.py:33-100, `raw2outputs`):
  - dists between consecutive z values, last dist 1e10, scaled by |ray dir|;
  - alpha = 1 - exp(-relu(sigma + noise) * dists), the Gaussian sigma noise
    a training regularizer (reference model_utils.py:64-71);
  - weights = alpha * exclusive-cumprod(1 - alpha + 1e-10), in linear space
    (a log-space product NaNs the gradients once density saturates);
  - rgb/depth/disp/acc maps, disp guarded where acc == 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor  # [..., 3]
    disp: torch.Tensor  # [...]
    acc: torch.Tensor  # [...]
    weights: torch.Tensor  # [..., S]
    depth: torch.Tensor  # [...]


class _CumprodPositive(torch.autograd.Function):
    """torch.cumprod along the last axis of an input with no zeros. Its
    gradient is PyTorch's own for that case (the reversed cumulative sum of
    output * grad, divided by the input), without the host-side test for
    zeros that PyTorch's backward makes first, which a CUDA graph of the
    training step (train/step.py::StepGraph) cannot hold."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """[1, x0, x0*x1, ...] along the last axis (reference model_utils.py:75-80),
    for x without zeros (the callers' 1 - alpha + 1e-10 >= 1e-10)."""
    ones = torch.ones_like(x[..., :1])
    return _CumprodPositive.apply(torch.cat([ones, x], -1))[..., :-1]


def _dists(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def sigma_to_weights(
    sigma: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor
) -> torch.Tensor:
    """Noiseless compositing weights from raw sigma [..., S] (the weights
    slice of `composite_rays`; JAX `sigma_to_weights`)."""
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * _dists(z_vals, rays_d))
    return alpha * exclusive_cumprod(1.0 - alpha + 1e-10)


def composite_rays(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    raw_noise_std: float = 0.0,
    noise: torch.Tensor | None = None,
    white_background: bool = False,
) -> RenderOutputs:
    """Alpha-composite raw [..., S, 4] predictions at depths [..., S]. With
    raw_noise_std > 0, `noise` (standard normal, [..., S]) times the std is
    added to sigma before the ReLU."""
    dists = _dists(z_vals, rays_d)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            raise ValueError("raw_noise_std > 0 requires noise")
        sigma = sigma + noise * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)

    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    acc_map = weights.sum(-1)
    # The reference's 1 / max(1e-10, depth/acc) is NaN at acc == 0.
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb=rgb_map, disp=disp_map, acc=acc_map, weights=weights, depth=depth_map)
