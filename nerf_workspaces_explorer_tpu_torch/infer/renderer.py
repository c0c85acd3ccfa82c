"""Full-frame NeRF inference: camera pose -> rendered image.

Counterpart of `nerf_workspaces_explorer_tpu/infer/renderer.py`, reference
preset (reference NeRFReplicaInferenceHandler,
nerf/inference/nerf_replica_inference_handler.py:23-277): config and
checkpoint loading, coarse+fine models, `render_coordinates(init, coord)` ->
uint8 [H, W, 3].

Two precisions pick the path:
  - "parity": fp32 weights through the plain pipeline
    (`render.pipeline.render_rays_chunked`);
  - "fast": bf16 weights through the fused path
    (`ops.fused_render.render_rays_fused`): on `cuda` the coarse render
    kernel, the importance-merge kernel and the fine render kernel, once each
    per frame; on `cpu` their plain versions.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
from nerf_workspaces_explorer_tpu_torch.core.config import FrameworkConfig, load_config
from nerf_workspaces_explorer_tpu_torch.core.types import COORD
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import (
    load_checkpoint,
    load_torch_checkpoint,
    params_from_numpy,
)
from nerf_workspaces_explorer_tpu_torch.models.encoding import embedding_output_dim
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLP, NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops.fused_render import (
    prepare_kernel_params,
    render_rays_fused,
)
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
from nerf_workspaces_explorer_tpu_torch.render.pipeline import (
    RenderSettings,
    render_rays_chunked,
)

PRECISIONS = ("parity", "fast")


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """`cuda` unless the caller names a device; never a silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the renderer runs on the GPU unless it is "
            "given device='cpu'"
        )
    return device


def settings_from_config(cfg: FrameworkConfig) -> RenderSettings:
    return RenderSettings(
        n_samples=cfg.rendering.n_samples,
        n_importance=cfg.rendering.n_importance,
        perturb=cfg.rendering.perturb,
        raw_noise_std=cfg.rendering.raw_noise_std,
        white_background=cfg.rendering.white_background,
        num_freqs_3d=cfg.rendering.num_freqs_3d,
        num_freqs_2d=cfg.rendering.num_freqs_2d,
        use_view_dirs=cfg.rendering.use_view_dirs,
    )


def spec_from_config(cfg: FrameworkConfig) -> NerfMLPSpec:
    return NerfMLPSpec(
        depth=cfg.model.net_depth,
        width=cfg.model.net_width,
        input_ch=embedding_output_dim(cfg.rendering.num_freqs_3d),
        input_ch_views=(
            embedding_output_dim(cfg.rendering.num_freqs_2d)
            if cfg.rendering.use_view_dirs
            else 0
        ),
        use_view_dirs=cfg.rendering.use_view_dirs,
    )


class NeRFRenderer:
    """Pose -> frame renderer for one workspace's trained NeRF."""

    def __init__(
        self,
        office_name: str,
        ckpt_path: Optional[str] = None,
        *,
        config: Optional[FrameworkConfig] = None,
        precision: str = "parity",
        preset: str = "reference",
        early_stop_eps: float = 1e-3,
        device: Optional[str | torch.device] = None,
    ) -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} ({'|'.join(PRECISIONS)})")
        if preset != "reference":
            raise ValueError(f"preset {preset!r} is not ported yet (reference only)")
        self._device = resolve_device(device)
        self._ckpt_path = ckpt_path
        self._config = config if config is not None else load_config(office_name=office_name)
        self._precision = precision
        # Fused-path early ray termination: samples past transmittance < eps
        # are skipped; the rgb error this commits is bounded by eps (1e-3 is
        # under half a uint8 step).
        self._early_stop_eps = early_stop_eps
        self._spec = spec_from_config(self._config)
        self._settings = settings_from_config(self._config).for_eval()
        self._models: Optional[Dict[str, NerfMLP]] = None  # parity
        self._kparams: Optional[Dict[str, Any]] = None  # fast

    @property
    def config(self) -> FrameworkConfig:
        return self._config

    def initialize_models(self) -> None:
        """Load checkpoint weights (torch `.ckpt` or native `.npz`).

        Mirrors reference initialize_models (…inference_handler.py:88-148),
        including its RuntimeError on a missing checkpoint.
        """
        if self._ckpt_path is None or not os.path.exists(self._ckpt_path):
            raise RuntimeError(
                f"Checkpoint path: {self._ckpt_path} for model cannot be found!"
            )
        if self._ckpt_path.endswith(".ckpt"):
            coarse, fine, _ = load_torch_checkpoint(self._ckpt_path)
            tree = {"coarse": coarse, "fine": fine}
        else:
            tree, _, _ = load_checkpoint(self._ckpt_path)
        if "coarse" not in tree or "fine" not in tree:
            raise ValueError(f"{self._ckpt_path} is not a coarse+fine checkpoint")
        # fast: bf16 weights, biases included, as the JAX package casts them.
        dtype = torch.bfloat16 if self._precision == "fast" else torch.float32
        params = params_from_numpy({k: tree[k] for k in ("coarse", "fine")}, self._device, dtype)
        if self._precision == "fast":
            self._kparams = {k: prepare_kernel_params(p, self._spec) for k, p in params.items()}
        else:
            self._models = {k: NerfMLP(p, self._spec) for k, p in params.items()}

    @torch.no_grad()
    def render_pose(self, c2w: np.ndarray) -> torch.Tensor:
        """Render one camera pose -> float32 [H, W, 3] on the renderer's device."""
        if self._kparams is None and self._models is None:
            raise RuntimeError("initialize_models() must be called before rendering")
        cfg = self._config
        h, w = cfg.experiment.image_height, cfg.experiment.image_width
        near, far = cfg.rendering.depth_range
        c2w = torch.as_tensor(np.asarray(c2w, dtype=np.float32), device=self._device)
        rays = create_rays(c2w, h, w, cfg.fx, cfg.fy, cfg.cx, cfg.cy, near, far).reshape(h * w)
        if self._precision == "fast":
            rgb = render_rays_fused(
                self._kparams, rays, self._settings, early_stop_eps=self._early_stop_eps
            )
        else:
            out = render_rays_chunked(
                self._models, rays, self._settings, chunk=cfg.inference.chunk
            )
            rgb = out.get("rgb_fine", out.get("rgb_coarse"))
        return rgb.to(torch.float32).reshape(h, w, 3)

    def render_pose_uint8(self, c2w: np.ndarray) -> torch.Tensor:
        """Render one camera pose straight to uint8 [H, W, 3] on the device
        (reference to8b_np, model_utils.py:10: floor(255 * clip))."""
        rgb = self.render_pose(c2w)
        return torch.floor(255.0 * torch.clamp(rgb, 0.0, 1.0)).to(torch.uint8)

    def render_coordinates(self, init_coordinates: COORD, coordinates: COORD) -> np.ndarray:
        """COORD pair -> uint8 [H, W, 3] numpy frame (reference
        render_coordinates, …inference_handler.py:166-185)."""
        pose = poses_from_coordinates(init_coordinates, [coordinates])[0]
        return self.render_pose_uint8(pose).cpu().numpy()
