"""Camera pose math: Euler angles -> camera-to-world matrices.

Parity target: reference utils/camera_poses.py:9-75. The reference composes
``c2w = R_roll @ R_pitch @ R_yaw @ T`` from degree-valued Euler angles
(utils/camera_poses.py:30-49) and then pre-multiplies per-view yaw/pitch
deltas built with cv2.Rodrigues onto the rotation block
(utils/camera_poses.py:52-75). We implement the same math in numpy with our
own Rodrigues formula so the compute path has no OpenCV dependency.

These run once per rendered frame on the host (a handful of 4x4 matmuls), so
they stay in numpy; ray generation downstream runs on the device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from nerf_workspaces_explorer_tpu_torch.core.types import COORD


def _trans_xyz(x: float, y: float, z: float) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[0, 3], t[1, 3], t[2, 3] = x, y, z
    return t


def _yaw_rotation(theta: float) -> np.ndarray:
    """Rotation about the Y axis (reference utils/camera_poses.py:14-17)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def _pitch_rotation(theta: float) -> np.ndarray:
    """Rotation about the X axis (reference utils/camera_poses.py:19-22)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _roll_rotation(theta: float) -> np.ndarray:
    """Rotation about the Z axis (reference utils/camera_poses.py:24-27)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> 3x3 rotation matrix (replaces cv2.Rodrigues).

    R = I + sin(t) K + (1 - cos(t)) K^2 where t = |rvec| and K is the
    cross-product matrix of the unit axis.
    """
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    axis = rvec / theta
    k = np.array(
        [
            [0.0, -axis[2], axis[1]],
            [axis[2], 0.0, -axis[0]],
            [-axis[1], axis[0], 0.0],
        ],
        dtype=np.float64,
    )
    return np.eye(3) + np.sin(theta) * k + (1.0 - np.cos(theta)) * (k @ k)


def camera_to_world_matrix(coordinates: COORD) -> np.ndarray:
    """Euler pose -> 4x4 c2w, matching reference utils/camera_poses.py:30-49.

    Note the reference's composition order: the translation matrix is
    multiplied on the *right* of the combined rotation (c2w = R @ T), so the
    translation column of the result is R[:3,:3] @ [x, y, z].
    """
    deg = np.pi / 180.0
    r = (
        _roll_rotation(coordinates.roll * deg)
        @ _pitch_rotation(coordinates.pitch * deg)
        @ _yaw_rotation(coordinates.yaw * deg)
    )
    return (r @ _trans_xyz(coordinates.x, coordinates.y, coordinates.z)).astype(np.float32)


def poses_from_coordinates(
    init_coordinates: COORD, coordinates: Sequence[COORD]
) -> np.ndarray:
    """Batch of c2w poses for per-view yaw/pitch deltas.

    Matches reference utils/camera_poses.py:52-75: each view starts from the
    init pose and pre-multiplies Rodrigues rotations about the world Z axis
    (yaw delta) and world X axis (pitch delta) onto the rotation block.
    Returns float32 [N, 4, 4].
    """
    deg = np.pi / 180.0
    poses: List[np.ndarray] = []
    for coord in coordinates:
        extrinsic = camera_to_world_matrix(init_coordinates).astype(np.float64)
        horizontal = rodrigues(np.array([0.0, 0.0, coord.yaw * deg]))
        vertical = rodrigues(np.array([coord.pitch * deg, 0.0, 0.0]))
        extrinsic[:3, :3] = horizontal @ vertical @ extrinsic[:3, :3]
        poses.append(extrinsic)
    return np.stack(poses, axis=0).astype(np.float32)
