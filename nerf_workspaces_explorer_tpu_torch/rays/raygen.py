"""Pinhole ray generation in world coordinates.

Counterpart of `nerf_workspaces_explorer_tpu/rays/raygen.py` (reference
nerf/rays/rays.py:6-71): camera-frame directions on the OpenCV grid (x right,
y down, z forward), rotated into the world by the pose's rotation block, the
origin broadcast from its translation. Rays are a structure of arrays;
`pack_rays`/`unpack_rays` convert to and from the reference's flat per-ray
record [o(3), d(3), near, far, viewdir(3)] of 11 floats (rays.py:26-31).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RayBundle(NamedTuple):
    """Structure-of-arrays ray batch. Leading dims are arbitrary batch dims."""

    origins: torch.Tensor  # [..., 3]
    dirs: torch.Tensor  # [..., 3] (unnormalized; z=1 in camera frame)
    near: torch.Tensor  # [..., 1]
    far: torch.Tensor  # [..., 1]
    viewdirs: torch.Tensor  # [..., 3] (unit-norm dirs)

    @property
    def batch_shape(self) -> torch.Size:
        return self.origins.shape[:-1]

    def reshape(self, *shape) -> "RayBundle":
        return RayBundle(
            origins=self.origins.reshape(*shape, 3),
            dirs=self.dirs.reshape(*shape, 3),
            near=self.near.reshape(*shape, 1),
            far=self.far.reshape(*shape, 1),
            viewdirs=self.viewdirs.reshape(*shape, 3),
        )

    def __getitem__(self, idx) -> "RayBundle":  # type: ignore[override]
        return RayBundle(*(field[idx] for field in self))


def camera_ray_dirs(
    height: int, width: int, fx: float, fy: float, cx: float, cy: float,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Camera-frame ray directions [H, W, 3] (reference rays.py:35-58)."""
    i = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    j = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    x = ((i - cx) / fx).expand(height, width)
    y = ((j - cy) / fy).expand(height, width)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def create_rays(
    c2w: torch.Tensor,
    height: int,
    width: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    near: float,
    far: float,
) -> RayBundle:
    """World-space rays for a batch of poses [N, 4, 4] (or one [4, 4]).

    Returns a RayBundle with batch shape [N, H*W] on `c2w`'s device.
    """
    c2w = c2w.to(torch.float32)
    if c2w.ndim == 2:
        c2w = c2w[None]
    n, device = c2w.shape[0], c2w.device
    dirs_cam = camera_ray_dirs(height, width, fx, fy, cx, cy, device).reshape(-1, 3)
    rot = c2w[:, :3, :3]
    # Elementwise products summed in a fixed order: a matmul here could take
    # a TF32 path on the card and move the rays by 1e-3.
    dirs_world = (rot[:, None, :, :] * dirs_cam[None, :, None, :]).sum(-1)  # [N, HW, 3]
    origins = c2w[:, None, :3, 3].expand_as(dirs_world)
    viewdirs = dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    shape = (n, height * width, 1)
    return RayBundle(
        origins=origins,
        dirs=dirs_world,
        near=torch.full(shape, near, dtype=torch.float32, device=device),
        far=torch.full(shape, far, dtype=torch.float32, device=device),
        viewdirs=viewdirs,
    )


def pack_rays(rays: RayBundle) -> torch.Tensor:
    """The reference's 11-float record layout [..., 11] (reference
    nerf/rays/rays.py:26-31)."""
    return torch.cat([rays.origins, rays.dirs, rays.near, rays.far, rays.viewdirs], dim=-1)


def unpack_rays(flat: torch.Tensor) -> RayBundle:
    """Inverse of `pack_rays` for reference-layout [..., 11] records."""
    return RayBundle(
        origins=flat[..., 0:3],
        dirs=flat[..., 3:6],
        near=flat[..., 6:7],
        far=flat[..., 7:8],
        viewdirs=flat[..., 8:11],
    )
