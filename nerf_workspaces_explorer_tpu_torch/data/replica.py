"""Training data splits.

Counterpart of `nerf_workspaces_explorer_tpu/data/replica.py`, without the
image loader: `SceneData` (one split's images, depths and poses) and the
reference's split rule, train ids = every 5th frame, test ids = train ids +
2 (reference nerf/datasets/replica_dataset.py:42-43). Training runs on the
analytic scenes of `data.synthetic`; the Replica loader is not ported and
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class SceneData:
    """One split's data: [N, H, W, 3] rgb, [N, H, W] depth, [N, 4, 4] poses."""

    rgb: np.ndarray
    depth: np.ndarray
    camera_pose: np.ndarray

    def __len__(self) -> int:
        return self.rgb.shape[0]


def split_ids(n_frames: int, train_stride: int = 5, test_offset: int = 2) -> Tuple[List[int], List[int]]:
    """(train ids, test ids) of an `n_frames` sequence (replica_dataset.py:42-43)."""
    train = list(range(0, n_frames, train_stride))
    return train, [i + test_offset for i in train]


class ReplicaDataset:
    """The Replica image loader, not ported: train on `data.synthetic` scenes."""

    def __init__(self, office_name: str, **_) -> None:
        raise NotImplementedError(
            f"the Replica loader is not ported (office {office_name!r}): pass train_data and "
            "test_data, e.g. from nerf_workspaces_explorer_tpu_torch.data.synthetic"
        )
