"""Replica dataset loader.

Counterpart of `nerf_workspaces_explorer_tpu/data/replica.py` (reference
nerf/datasets/replica_dataset.py:20-161), with the same behaviour:
  - directory layout `replica_dataset/<office>/Sequence_1/{traj_w_c.txt,
    rgb/rgb_*.png, depth/depth_*.png}`, the office named either way
    (`office_tokyo` or Replica's `office0`, `resolve_scene_dir`);
  - train ids = every 5th frame, test ids = train ids + 2 (`split_ids`);
  - images sorted by the integer frame index in their filename;
  - RGB uint8 / 255 and depth uint16 millimetres / 1000, in float64, then
    float32 in the split;
  - a bilinear resize to the configured H x W where it differs, with the
    arithmetic of cv2's INTER_LINEAR (half-pixel centres, no antialiasing,
    float64), which the reference and the JAX loader use;
  - poses from `loadtxt(...).reshape(-1, 4, 4)`.

PNGs decode with the port's own codec (`utils.png`); no image library is
needed. Depth is loaded but, as in the reference, never used by the
photometric loss.
"""

from __future__ import annotations

import glob
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from nerf_workspaces_explorer_tpu_torch.utils.png import SUB, read_png, read_rgb, write_png

DATASETS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "replica_dataset")

# Office <-> Replica scene name mapping (reference
# application/workspaces/mapping.txt:3-6). A real Replica download holds
# directories named office0..office4; the loader accepts either naming.
OFFICE_TO_REPLICA_SCENE = {
    "office_tokyo": "office0",
    "office_new_york": "office1",
    "office_geneve": "office2",
    "office_belgrade": "office4",
}
REPLICA_SCENE_TO_OFFICE = {v: k for k, v in OFFICE_TO_REPLICA_SCENE.items()}


def resolve_scene_dir(office_name: str, datasets_path: Optional[str] = None) -> str:
    """An office's `Sequence_1` directory under `datasets_path` (default
    `DATASETS_PATH`), by the framework's name (`office_tokyo`) or the raw
    Replica scene's (`office0`)."""
    datasets_path = DATASETS_PATH if datasets_path is None else datasets_path
    candidates = [office_name]
    for mapping in (OFFICE_TO_REPLICA_SCENE, REPLICA_SCENE_TO_OFFICE):
        if office_name in mapping:
            candidates.append(mapping[office_name])
    for cand in candidates:
        d = os.path.join(datasets_path, cand, "Sequence_1")
        if os.path.isdir(d):
            return d
    raise FileNotFoundError(
        f"no Replica sequence for {office_name!r} under {datasets_path!r} (tried {candidates})"
    )


def split_ids(n_frames: int, train_stride: int = 5, test_offset: int = 2) -> Tuple[List[int], List[int]]:
    """(train ids, test ids) of an `n_frames` sequence (replica_dataset.py:42-43)."""
    train = list(range(0, n_frames, train_stride))
    return train, [i + test_offset for i in train]


def imread_rgb(path: str) -> np.ndarray:
    """An image as RGB float64 in [0, 1]."""
    return read_rgb(path) / 255.0


def imread_depth(path: str) -> np.ndarray:
    """A depth image (millimetres) as float64 metres."""
    depth = read_png(path)
    if depth.ndim != 2:
        raise ValueError(f"{path}: a depth frame must be single-channel, got shape {depth.shape}")
    return depth / 1000.0


def resize_bilinear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W] or [H, W, C] float64 -> [height, width(, C)]: cv2.resize's
    INTER_LINEAR (source point (d + 0.5) * scale - 0.5, clamped at the
    edges, no antialiasing) up and down, in float64."""
    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float64))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=False)[0]
    return (out[0] if image.ndim == 2 else out.permute(1, 2, 0)).numpy()


def write_sequence(
    scene_dir: str,
    rgb: np.ndarray,
    depth_mm: np.ndarray,
    poses: np.ndarray,
    filters: Optional[Sequence[Union[int, Sequence[int]]]] = None,
) -> None:
    """Write a sequence in the layout `ReplicaDataset` reads, under
    `scene_dir` (a `Sequence_1` directory): rgb/rgb_<i>.png from uint8
    [N, H, W, 3], depth/depth_<i>.png from uint16 millimetres [N, H, W],
    traj_w_c.txt from [N, 4, 4] poses. `filters[i]` is frame i's PNG row
    filter, or one per row (`utils.png.encode_png`); Sub by default, as
    cv2 writes."""
    os.makedirs(os.path.join(scene_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "depth"), exist_ok=True)

    def write_frame(i: int) -> None:
        frame_filters = SUB if filters is None else filters[i]
        write_png(os.path.join(scene_dir, "rgb", f"rgb_{i}.png"), rgb[i], frame_filters)
        write_png(os.path.join(scene_dir, "depth", f"depth_{i}.png"), depth_mm[i], frame_filters)

    # Threads overlap the frames' zlib compression, which releases the GIL.
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write_frame, range(len(rgb))))
    np.savetxt(os.path.join(scene_dir, "traj_w_c.txt"), np.asarray(poses).reshape(len(poses), 16), delimiter=" ")


@dataclass
class SceneData:
    """One split's data: [N, H, W, 3] rgb, [N, H, W] depth, [N, 4, 4] poses."""

    rgb: np.ndarray
    depth: np.ndarray
    camera_pose: np.ndarray

    def __len__(self) -> int:
        return self.rgb.shape[0]

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {"rgb": self.rgb, "depth": self.depth, "camera_pose": self.camera_pose}


def _frame_index(path: str) -> int:
    match = re.search(r"_(\d+)\.\w+$", os.path.basename(path))
    if match is None:
        raise ValueError(f"unrecognized frame filename: {path}")
    return int(match.group(1))


class ReplicaDataset:
    """Train/test splits of one Replica office sequence."""

    def __init__(
        self,
        office_name: str,
        *,
        image_height: Optional[int] = None,
        image_width: Optional[int] = None,
        datasets_path: Optional[str] = None,
        train_stride: int = 5,
        test_offset: int = 2,
    ) -> None:
        self._dataset_dir = resolve_scene_dir(office_name, datasets_path)
        self._img_h = image_height
        self._img_w = image_width

        traj_file = os.path.join(self._dataset_dir, "traj_w_c.txt")
        rgb_dir = os.path.join(self._dataset_dir, "rgb")
        depth_dir = os.path.join(self._dataset_dir, "depth")

        n_frames = len(os.listdir(rgb_dir))
        self._train_ids, self._test_ids = split_ids(n_frames, train_stride, test_offset)

        self._camera_poses = np.loadtxt(traj_file, delimiter=" ").reshape(-1, 4, 4)
        self._rgb_images = sorted(glob.glob(rgb_dir + "/rgb*.png"), key=_frame_index)
        self._depth_images = sorted(glob.glob(depth_dir + "/depth*.png"), key=_frame_index)

        self.train = self._load_split(self._train_ids)
        self.test = self._load_split(self._test_ids)

    # Reference-compatible accessors (replica_dataset.py:66-82).
    @property
    def train_dataset(self) -> Dict[str, np.ndarray]:
        return self.train.as_dict()

    @property
    def test_dataset(self) -> Dict[str, np.ndarray]:
        return self.test.as_dict()

    @property
    def train_dataset_len(self) -> int:
        return len(self.train)

    @property
    def test_dataset_len(self) -> int:
        return len(self.test)

    def _load_frame(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rgb = imread_rgb(self._rgb_images[idx])
        depth = imread_depth(self._depth_images[idx])
        if (self._img_h is not None and self._img_h != rgb.shape[0]) or (
            self._img_w is not None and self._img_w != rgb.shape[1]
        ):
            height = self._img_h if self._img_h is not None else rgb.shape[0]
            width = self._img_w if self._img_w is not None else rgb.shape[1]
            rgb = resize_bilinear(rgb, width, height)
            depth = resize_bilinear(depth, width, height)
        return rgb, depth

    def _load_split(self, ids: List[int]) -> SceneData:
        rgbs, depths, poses = [], [], []
        for idx in ids:
            rgb, depth = self._load_frame(idx)
            rgbs.append(rgb)
            depths.append(depth)
            poses.append(self._camera_poses[idx])
        return SceneData(
            rgb=np.asarray(rgbs, dtype=np.float32),
            depth=np.asarray(depths, dtype=np.float32),
            camera_pose=np.asarray(poses, dtype=np.float32),
        )

    def __str__(self) -> str:
        def split_str(name: str, split: SceneData) -> str:
            return (
                f"{name}: {len(split)} frames, rgb {split.rgb.shape} "
                f"{split.rgb.dtype}, depth {split.depth.shape}, "
                f"poses {split.camera_pose.shape}"
            )

        return "ReplicaDataset\n" + split_str("train", self.train) + "\n" + split_str("test", self.test)
