"""Coarse+fine hierarchical rendering in plain PyTorch (the fp32 "parity"
precision).

Counterpart of `nerf_workspaces_explorer_tpu/render/pipeline.py` in eval mode
(reference nerf/inference/nerf_replica_inference_handler.py:203-277): 64
linear coarse depths through the coarse net, deterministic inverse-CDF
importance samples from its weights, the sorted union through the fine net,
compositing. Training-mode rendering (perturbation, sigma noise, random
importance samples) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

from nerf_workspaces_explorer_tpu_torch.models.encoding import positional_encoding
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLP
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.rays.sampling import (
    coarse_z_vals,
    merge_sorted_z,
    sample_pdf,
)
from nerf_workspaces_explorer_tpu_torch.render.volume import composite_rays


class RenderSettings(NamedTuple):
    """Rendering hyperparameters (defaults: reference office_tokyo_config.yaml:20-31)."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_background: bool = False
    num_freqs_3d: int = 10
    num_freqs_2d: int = 4
    use_view_dirs: bool = True
    train: bool = False

    def for_eval(self) -> "RenderSettings":
        """Inference variant: no perturbation, no sigma noise, det sampling."""
        return self._replace(train=False, raw_noise_std=0.0)


def _eval_network(
    model: NerfMLP, pts: torch.Tensor, viewdirs: torch.Tensor, settings: RenderSettings
) -> torch.Tensor:
    """Encode [R, S, 3] points (+ per-ray viewdirs [R, 3]) -> raw [R, S, 4]."""
    encoded_pts = positional_encoding(pts, settings.num_freqs_3d, scalar_factor=10.0)
    encoded_views = None
    if settings.use_view_dirs:
        enc = positional_encoding(viewdirs, settings.num_freqs_2d, scalar_factor=1.0)
        encoded_views = enc[:, None, :].expand(pts.shape[0], pts.shape[1], enc.shape[-1])
    return model(encoded_pts, encoded_views)


def render_ray_bundle(
    models: Mapping[str, NerfMLP],
    rays: RayBundle,
    settings: RenderSettings,
    *,
    full_outputs: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render a flat bundle [R] through {"coarse", "fine"} nets.

    Returns the reference's output names (…inference_handler.py:256-268):
    rgb/disp/acc/depth `_fine`, plus the `_coarse` maps when `full_outputs`
    or when there is no importance pass.
    """
    if settings.train:
        raise NotImplementedError("training-mode rendering is not ported yet")
    z_vals = coarse_z_vals(rays.near, rays.far, settings.n_samples)  # [R, S]
    viewdirs = rays.viewdirs
    pts = rays.origins[..., None, :] + rays.dirs[..., None, :] * z_vals[..., :, None]
    raw_coarse = _eval_network(models["coarse"], pts, viewdirs, settings)
    out_coarse = composite_rays(
        raw_coarse, z_vals, rays.dirs, white_background=settings.white_background
    )
    outputs: Dict[str, torch.Tensor] = {}
    if settings.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mid, out_coarse.weights[..., 1:-1], settings.n_importance)
        z_fine = merge_sorted_z(z_vals, z_samples)
        pts = rays.origins[..., None, :] + rays.dirs[..., None, :] * z_fine[..., :, None]
        raw_fine = _eval_network(models["fine"], pts, viewdirs, settings)
        out_fine = composite_rays(
            raw_fine, z_fine, rays.dirs, white_background=settings.white_background
        )
        outputs.update(
            rgb_fine=out_fine.rgb, disp_fine=out_fine.disp,
            acc_fine=out_fine.acc, depth_fine=out_fine.depth,
        )
    if full_outputs or settings.n_importance == 0:
        outputs.update(
            rgb_coarse=out_coarse.rgb, disp_coarse=out_coarse.disp,
            acc_coarse=out_coarse.acc, depth_coarse=out_coarse.depth,
        )
    return outputs


@torch.no_grad()
def render_rays_chunked(
    models: Mapping[str, NerfMLP],
    rays: RayBundle,
    settings: RenderSettings,
    *,
    chunk: int = 8192,
) -> Dict[str, torch.Tensor]:
    """Render a large flat bundle in `chunk`-ray tiles (reference
    utils/batch_utils.py:7-25; inference chunk 8192). The ray count is padded
    to a multiple of `chunk` by repeating the last ray, as the JAX package
    does, so every tile has one shape and padded lanes stay finite."""
    n = rays.origins.shape[0]
    padded = -(-n // chunk) * chunk

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x[-1:].expand(padded - n, *x.shape[1:])], 0)

    rays = RayBundle(*(pad(field) for field in rays))
    tiles = [
        render_ray_bundle(models, rays[i : i + chunk], settings.for_eval())
        for i in range(0, padded, chunk)
    ]
    return {k: torch.cat([t[k] for t in tiles], 0)[:n] for k in tiles[0]}
