"""Analytic scenes with ray-marched ground truth, for training without the
Replica images.

Counterpart of `nerf_workspaces_explorer_tpu/data/synthetic.py`: the blob
orbit scene (`make_synthetic_scene`) and the room walkthrough
(`make_room_scene_splits`, the reference's every-5th / +2 split rule over a
figure-eight tour of a textured room), and the room's off-tour poses that
distillation trains on and is gated on (`room_coverage_poses`,
`room_grid_poses`). Scenes are numpy, drawn from a seed
exactly as the JAX package draws them; ground truth is dense-marched in
torch on the caller's device through the same compositing the model uses.
With `cache_dir`, rendered splits are memoized as uint8 rgb and float16
depth under the JAX package's keys, and fresh and cached callers both get
the quantized values.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.data.replica import SceneData
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals
from nerf_workspaces_explorer_tpu_torch.render.volume import composite_rays

# Rays marched at a time (bounds the [rays, samples, objects, 3] temporaries).
RAY_CHUNK = 4096
# Bump when the analytic field / trajectory definition changes (the JAX
# package's _ROOM_GT_VERSION: caches are shared).
_ROOM_GT_VERSION = 1


class BlobScene(NamedTuple):
    """Colored Gaussian density blobs: centers [K,3], radii [K], colors [K,3],
    peak densities [K]."""

    centers: np.ndarray
    radii: np.ndarray
    colors: np.ndarray
    densities: np.ndarray


def default_scene(num_blobs: int = 5, seed: int = 0) -> BlobScene:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.8, 0.8, size=(num_blobs, 3)).astype(np.float32)
    radii = rng.uniform(0.25, 0.5, size=(num_blobs,)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, size=(num_blobs, 3)).astype(np.float32)
    densities = rng.uniform(20.0, 60.0, size=(num_blobs,)).astype(np.float32)
    return BlobScene(centers, radii, colors, densities)


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _logit(rgb: torch.Tensor) -> torch.Tensor:
    rgb = torch.clamp(rgb, 1e-4, 1.0 - 1e-4)
    return torch.log(rgb) - torch.log1p(-rgb)  # inverse sigmoid


def field_fn(scene: BlobScene, pts: torch.Tensor) -> torch.Tensor:
    """Analytic radiance field: [..., 3] points -> raw [..., 4] (rgb logits,
    sigma), so that `composite_rays`' sigmoid and ReLU give the field."""
    dev = pts.device
    centers, radii = _t(scene.centers, dev), _t(scene.radii, dev)
    colors, densities = _t(scene.colors, dev), _t(scene.densities, dev)
    d2 = ((pts[..., None, :] - centers) ** 2).sum(-1)  # [..., K]
    blob = torch.exp(-d2 / (2.0 * radii**2))
    sigma = (blob * densities).sum(-1)
    color_w = blob + 1e-8
    rgb = torch.einsum("...k,kc->...c", color_w, colors) / color_w.sum(-1, keepdim=True)
    return torch.cat([_logit(rgb), sigma[..., None]], -1)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenCV camera-to-world (x right, y down, z forward), image up = +y."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    world_up = np.array([0.0, -1.0, 0.0])
    right = np.cross(world_up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, forward, eye
    return c2w


def orbit_poses(n: int, radius: float = 2.5, height: float = 0.4, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-world poses on a circle looking at the target."""
    target = np.asarray(target, dtype=np.float64)
    poses = []
    for k in range(n):
        angle = 2.0 * np.pi * k / n
        eye = np.array([radius * np.cos(angle), height, radius * np.sin(angle)], dtype=np.float64)
        poses.append(_look_at(eye, target))
    return np.stack(poses).astype(np.float32)


def _march(field, poses, height, width, near, far, n_samples, hfov_degrees, device):
    """Dense-march `field` ([..., 3] -> raw [..., 4]) from each pose ->
    (rgb [N, H, W, 3], depth [N, H, W]) numpy."""
    fx = width / 2.0 / np.tan(np.radians(hfov_degrees / 2.0))
    cx, cy = (width - 1.0) / 2.0, (height - 1.0) / 2.0
    rgbs, depths = [], []
    with torch.no_grad():
        for pose in np.asarray(poses, np.float32):
            rays = create_rays(_t(pose, device), height, width, fx, fx, cx, cy, near, far)
            rays = rays.reshape(height * width)
            rgb, depth = [], []
            for r0 in range(0, height * width, RAY_CHUNK):
                tile = rays[r0 : r0 + RAY_CHUNK]
                z = coarse_z_vals(tile.near, tile.far, n_samples)
                pts = tile.origins[:, None, :] + tile.dirs[:, None, :] * z[..., None]
                out = composite_rays(field(pts), z, tile.dirs)
                rgb.append(out.rgb)
                depth.append(out.depth)
            rgbs.append(torch.cat(rgb).reshape(height, width, 3).cpu().numpy())
            depths.append(torch.cat(depth).reshape(height, width).cpu().numpy())
    return np.stack(rgbs), np.stack(depths)


def render_ground_truth(
    scene: BlobScene,
    poses: np.ndarray,
    height: int,
    width: int,
    *,
    near: float = 0.1,
    far: float = 6.0,
    n_samples: int = 192,
    hfov_degrees: float = 90.0,
    device: torch.device | str = "cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense-march the blob field -> (rgb [N,H,W,3], depth [N,H,W])."""
    return _march(lambda p: field_fn(scene, p), poses, height, width, near, far, n_samples,
                  hfov_degrees, device)


class RoomScene(NamedTuple):
    """Analytic office room (JAX package `RoomScene`): textured walls, floor
    and ceiling plus furniture-like anisotropic blobs and soft boxes."""

    half: np.ndarray  # [3] room half-extents (meters)
    wall_sharp: float
    wall_density: float
    wall_freqs: np.ndarray  # [3, 3]
    wall_phases: np.ndarray  # [3]
    blob_centers: np.ndarray  # [K, 3]
    blob_inv_r2: np.ndarray  # [K, 3]
    blob_colors: np.ndarray  # [K, 3]
    blob_densities: np.ndarray  # [K]
    blob_pattern: np.ndarray  # [K, 3]
    box_centers: np.ndarray  # [M, 3]
    box_half: np.ndarray  # [M, 3]
    box_colors: np.ndarray  # [M, 3]
    box_densities: np.ndarray  # [M]
    box_pattern: np.ndarray  # [M, 3]
    box_sharp: float


def room_scene(num_blobs: int = 8, num_boxes: int = 6, seed: int = 7) -> RoomScene:
    """A 5 x 2.8 x 6 m room with objects in its lower half, drawn from `seed`
    in the JAX package's order."""
    rng = np.random.default_rng(seed)
    half = np.array([2.5, 1.4, 3.0], dtype=np.float32)
    place = half * np.array([0.78, 0.55, 0.78], dtype=np.float32)

    centers = rng.uniform(-1.0, 1.0, size=(num_blobs, 3)).astype(np.float32) * place
    centers[:, 1] = rng.uniform(0.5, 0.82, size=num_blobs) * half[1]
    radii = rng.uniform(0.18, 0.45, size=(num_blobs, 3)).astype(np.float32)
    blob_colors = rng.uniform(0.15, 1.0, size=(num_blobs, 3)).astype(np.float32)
    blob_densities = rng.uniform(30.0, 80.0, size=(num_blobs,)).astype(np.float32)
    blob_pattern = rng.uniform(4.0, 9.0, size=(num_blobs, 3)).astype(np.float32) * rng.choice(
        [-1.0, 1.0], size=(num_blobs, 3)).astype(np.float32)

    box_centers = rng.uniform(-1.0, 1.0, size=(num_boxes, 3)).astype(np.float32) * place
    box_centers[:, 1] = rng.uniform(0.55, 0.85, size=num_boxes) * half[1]
    box_half = rng.uniform(0.15, 0.45, size=(num_boxes, 3)).astype(np.float32)
    box_colors = rng.uniform(0.15, 1.0, size=(num_boxes, 3)).astype(np.float32)
    box_densities = rng.uniform(40.0, 90.0, size=(num_boxes,)).astype(np.float32)
    box_pattern = rng.uniform(5.0, 11.0, size=(num_boxes, 3)).astype(np.float32) * rng.choice(
        [-1.0, 1.0], size=(num_boxes, 3)).astype(np.float32)

    wall_freqs = rng.uniform(2.5, 7.5, size=(3, 3)).astype(np.float32) * rng.choice(
        [-1.0, 1.0], size=(3, 3)).astype(np.float32)
    wall_phases = rng.uniform(0.0, 2.0 * np.pi, size=(3,)).astype(np.float32)
    return RoomScene(
        half=half, wall_sharp=24.0, wall_density=120.0, wall_freqs=wall_freqs,
        wall_phases=wall_phases, blob_centers=centers, blob_inv_r2=1.0 / radii**2,
        blob_colors=blob_colors, blob_densities=blob_densities, blob_pattern=blob_pattern,
        box_centers=box_centers, box_half=box_half, box_colors=box_colors,
        box_densities=box_densities, box_pattern=box_pattern, box_sharp=28.0,
    )


def room_field_fn(scene: RoomScene, pts: torch.Tensor) -> torch.Tensor:
    """Analytic radiance field of a RoomScene: [..., 3] -> raw [..., 4]."""
    dev, p = pts.device, pts
    t = lambda x: _t(x, dev)  # noqa: E731
    outside = torch.sigmoid((torch.abs(p) - t(scene.half)) * scene.wall_sharp)
    w_wall = scene.wall_density * outside.sum(-1)
    phase = torch.einsum("...i,ci->...c", p, t(scene.wall_freqs)) + t(scene.wall_phases)
    wall_rgb = (
        0.52
        + 0.30 * torch.sin(phase) * torch.cos(0.6 * torch.flip(phase, [-1]) + 1.3)
        + 0.12 * torch.sin(2.7 * phase + 0.7)
    )
    d2 = ((p[..., None, :] - t(scene.blob_centers)) ** 2 * t(scene.blob_inv_r2)).sum(-1)
    w_blob = torch.exp(-0.5 * d2) * t(scene.blob_densities)  # [..., K]
    blob_mod = 0.78 + 0.22 * torch.sin(torch.einsum("...i,ki->...k", p, t(scene.blob_pattern)))
    blob_rgb = t(scene.blob_colors) * blob_mod[..., None]  # [..., K, 3]
    inside = torch.sigmoid(
        (t(scene.box_half) - torch.abs(p[..., None, :] - t(scene.box_centers))) * scene.box_sharp
    )
    w_box = torch.prod(inside, -1) * t(scene.box_densities)  # [..., M]
    box_mod = 0.72 + 0.28 * torch.sin(torch.einsum("...i,mi->...m", p, t(scene.box_pattern)))
    box_rgb = t(scene.box_colors) * box_mod[..., None]
    sigma = w_wall + w_blob.sum(-1) + w_box.sum(-1)
    weight_sum = w_wall + w_blob.sum(-1) + w_box.sum(-1) + 1e-6
    rgb = (
        w_wall[..., None] * wall_rgb
        + torch.einsum("...k,...kc->...c", w_blob, blob_rgb)
        + torch.einsum("...m,...mc->...c", w_box, box_rgb)
    ) / weight_sum[..., None]
    return torch.cat([_logit(rgb), sigma[..., None]], -1)


def walkthrough_poses(n_frames: int, half=(2.5, 1.4, 3.0), seed: int = 0) -> np.ndarray:
    """A figure-eight walkthrough of the room interior with a gentle height
    bob, gaze sweeping the walls ahead (JAX `walkthrough_poses`)."""
    hx, hy, hz = (float(h) for h in half)
    t = 2.0 * np.pi * np.arange(n_frames) / n_frames
    eye = np.stack([
        0.55 * hx * np.sin(t + 0.35 * np.sin(2 * t)),
        0.16 * hy * np.sin(3 * t) - 0.08 * hy,
        0.55 * hz * np.sin(2 * t),
    ], axis=-1)
    phi = t * 3.0 + 0.5
    target = np.stack([
        0.85 * hx * np.cos(phi),
        0.28 * hy * np.sin(1.7 * phi + 1.0) + 0.22 * hy,
        0.85 * hz * np.sin(phi),
    ], axis=-1)
    return np.stack([_look_at(eye[k], target[k]) for k in range(n_frames)]).astype(np.float32)


def room_grid_poses(
    half=(2.5, 1.4, 3.0),
    grid: int = 3,
    yaws=(0.0, 90.0, 180.0, 270.0),
    y: float = -0.1,
    margin: float = 0.45,
) -> np.ndarray:
    """A `grid` x `grid` lattice of positions over the room's floor crossed
    with fixed yaw headings, off the walkthrough tour: the held-out probe
    views a distilled student is gated on (JAX `room_grid_poses`)."""
    hx, _, hz = (float(h) for h in half)
    xs = np.linspace(-hx * (1 - margin), hx * (1 - margin), grid)
    zs = np.linspace(-hz * (1 - margin), hz * (1 - margin), grid)
    poses = []
    for x in xs:
        for z in zs:
            for yaw in yaws:
                a = np.radians(yaw)
                forward = np.array([np.sin(a), 0.12, np.cos(a)])
                forward /= np.linalg.norm(forward)
                right = np.cross(np.array([0.0, -1.0, 0.0]), forward)
                right /= np.linalg.norm(right)
                down = np.cross(forward, right)
                c2w = np.eye(4, dtype=np.float64)
                c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, down, forward
                c2w[:3, 3] = np.array([x, y, z])
                poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def room_coverage_poses(half=(2.5, 1.4, 3.0)) -> np.ndarray:
    """Off-tour coverage views for distilling an interior: a 4 x 4 position
    lattice crossed with 45-degree-offset yaws at two camera heights, apart
    from the probe grid of `room_grid_poses` by construction (JAX
    `room_coverage_poses`)."""
    half = np.asarray(half, dtype=np.float32)
    yaws = (45.0, 135.0, 225.0, 315.0)
    return np.concatenate([
        room_grid_poses(half=half, grid=4, yaws=yaws, y=-0.3),
        room_grid_poses(half=half, grid=4, yaws=yaws, y=0.15),
    ])


def _quantize(rgb: np.ndarray, depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8), depth.astype(np.float16)


def render_room_ground_truth(
    scene: RoomScene,
    poses: np.ndarray,
    height: int,
    width: int,
    *,
    near: float = 0.1,
    far: float = 8.0,
    n_samples: int = 320,
    hfov_degrees: float = 90.0,
    cache_dir: Optional[str] = None,
    device: torch.device | str = "cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense-march the room field -> (rgb [N,H,W,3], depth [N,H,W]); with
    `cache_dir`, memoized and served quantized (JAX synthetic.py:389-447)."""
    poses = np.asarray(poses, dtype=np.float32)
    key = None
    if cache_dir is not None:
        digest = hashlib.md5()
        digest.update(repr((height, width, near, far, n_samples, hfov_degrees,
                            _ROOM_GT_VERSION)).encode())
        digest.update(np.ascontiguousarray(poses).tobytes())
        for field in scene:
            digest.update(np.ascontiguousarray(np.asarray(field, np.float32)).tobytes())
        key = os.path.join(cache_dir, f"room_gt_{digest.hexdigest()[:12]}.npz")
        if os.path.exists(key):
            with np.load(key) as arrays:
                return arrays["rgb"].astype(np.float32) / 255.0, arrays["depth"].astype(np.float32)
    rgb, depth = _march(lambda p: room_field_fn(scene, p), poses, height, width, near, far,
                        n_samples, hfov_degrees, device)
    if key is not None:
        os.makedirs(cache_dir, exist_ok=True)
        rgb8, depth16 = _quantize(rgb, depth)
        np.savez_compressed(key, rgb=rgb8, depth=depth16)
        return rgb8.astype(np.float32) / 255.0, depth16.astype(np.float32)
    return rgb, depth


def make_room_scene_splits(
    n_frames: int = 900,
    stride: int = 5,
    height: int = 240,
    width: int = 320,
    *,
    seed: int = 7,
    near: float = 0.1,
    far: float = 8.0,
    cache_dir: Optional[str] = None,
    gt_samples: int = 320,
    device: torch.device | str = "cpu",
) -> Tuple[SceneData, SceneData, RoomScene]:
    """Train ids = every `stride`th frame of the `n_frames` walkthrough, test
    ids = train ids + 2 (mod n_frames). With `cache_dir`, the rendered splits
    are memoized (JAX synthetic.py:450-530, same file names and contents)."""
    scene = room_scene(seed=seed)
    key = None
    if cache_dir is not None:
        digest = hashlib.md5()
        digest.update(repr((n_frames, stride, height, width, seed, near, far, gt_samples,
                            _ROOM_GT_VERSION)).encode())
        key = os.path.join(cache_dir, f"room_{digest.hexdigest()[:12]}.npz")
        if os.path.exists(key):
            with np.load(key) as a:
                train = SceneData(a["train_rgb"].astype(np.float32) / 255.0, a["train_depth"],
                                  a["train_pose"])
                test = SceneData(a["test_rgb"].astype(np.float32) / 255.0, a["test_depth"],
                                 a["test_pose"])
            return train, test, scene

    all_poses = walkthrough_poses(n_frames, half=scene.half)
    train_ids = np.arange(0, n_frames, stride)
    test_ids = (train_ids + 2) % n_frames
    kw = dict(near=near, far=far, n_samples=gt_samples, device=device)
    train_rgb, train_depth = render_room_ground_truth(scene, all_poses[train_ids], height, width, **kw)
    test_rgb, test_depth = render_room_ground_truth(scene, all_poses[test_ids], height, width, **kw)
    if key is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(
            key,
            train_rgb=np.round(train_rgb * 255.0).astype(np.uint8),
            train_depth=train_depth.astype(np.float16),
            train_pose=all_poses[train_ids],
            test_rgb=np.round(test_rgb * 255.0).astype(np.uint8),
            test_depth=test_depth.astype(np.float16),
            test_pose=all_poses[test_ids],
        )
        # Reload so cached and fresh callers see the same quantized data.
        return make_room_scene_splits(n_frames, stride, height, width, seed=seed, near=near,
                                      far=far, cache_dir=cache_dir, gt_samples=gt_samples,
                                      device=device)
    train = SceneData(train_rgb, train_depth, all_poses[train_ids])
    test = SceneData(test_rgb, test_depth, all_poses[test_ids])
    return train, test, scene


def make_synthetic_scene(
    n_train: int = 8,
    n_test: int = 2,
    height: int = 48,
    width: int = 64,
    *,
    seed: int = 0,
    near: float = 0.1,
    far: float = 6.0,
    device: torch.device | str = "cpu",
) -> Tuple[SceneData, SceneData, BlobScene]:
    """(train split, test split, scene) of the blob orbit scene."""
    scene = default_scene(seed=seed)
    train_poses = orbit_poses(n_train)
    test_poses = orbit_poses(2 * max(n_test, 1) + 1, radius=2.4, height=0.6)[1 : 1 + n_test]
    kw = dict(near=near, far=far, device=device)
    train_rgb, train_depth = render_ground_truth(scene, train_poses, height, width, **kw)
    test_rgb, test_depth = render_ground_truth(scene, test_poses, height, width, **kw)
    return (SceneData(train_rgb, train_depth, train_poses),
            SceneData(test_rgb, test_depth, test_poses), scene)
