"""Camera poses of the benchmark's requests, worked out without the program.

Frozen copies of the reference application's floor-plan calibrations
(application/workspace.py: each office's x'/z' extents, the angle between
the plan's axes and the world's, the camera height y = -0.5 and initial
pitch -90 degrees; new_york maps rel_x to x', the others rel_y), its pose
composition (utils/camera_poses.py: c2w = R_roll R_pitch R_yaw T, then the
view's yaw about world Z and pitch about world X pre-multiplied onto the
rotation), and the synthetic room's figure-eight walkthrough.
"""

from __future__ import annotations

import numpy as np

# office: (x' max, x' min, z' max, z' min, angle between the axes in degrees, rel_x -> x')
OFFICES = {
    "office_tokyo": (2.0, -2.0, 1.5, -3.0, -10.0, False),
    "office_new_york": (1.8, -1.2, 2.0, -1.6, 45.0, True),
    "office_geneve": (1.7, -2.5, 4.2, -2.8, 35.0, False),
    "office_belgrade": (4.7, -0.7, 3.5, -2.3, -10.0, False),
}
FIXED_Y = -0.5
INIT_PITCH = -90.0


def _rot(axis: int, theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float64)
    i, j = {0: (1, 2), 1: (2, 0), 2: (0, 1)}[axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _rodrigues(rvec) -> np.ndarray:
    rvec = np.asarray(rvec, np.float64)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    a = rvec / theta
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(theta) * k + (1.0 - np.cos(theta)) * (k @ k)


def click_pose(office: str, rel_x: float, rel_y: float, hor_angle: float, ver_angle: float) -> np.ndarray:
    """float32 [4, 4] camera-to-world matrix of a click on an office's plan."""
    x_max, x_min, z_max, z_min, angle, swap = OFFICES[office]
    u, v = (rel_x, rel_y) if swap else (rel_y, rel_x)
    cos_diff = np.cos(angle / 180.0 * np.pi)
    x = ((x_min - x_max) * u + x_max) / cos_diff
    z = ((z_min - z_max) * v + z_max) / cos_diff
    deg = np.pi / 180.0
    # yaw 0 and roll 0 at the initial pose: R = R_pitch
    trans = np.eye(4)
    trans[:3, 3] = (x, FIXED_Y, z)
    extrinsic = _rot(0, INIT_PITCH * deg) @ _rot(1, 0.0) @ trans
    extrinsic = extrinsic.astype(np.float32).astype(np.float64)
    yaw, pitch = -float(hor_angle), float(ver_angle)
    extrinsic[:3, :3] = _rodrigues([0.0, 0.0, yaw * deg]) @ _rodrigues([pitch * deg, 0.0, 0.0]) @ extrinsic[:3, :3]
    return extrinsic.astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(np.array([0.0, -1.0, 0.0]), forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, forward, eye
    return c2w


def walkthrough_poses(n_frames: int, half=(2.5, 1.4, 3.0)) -> np.ndarray:
    """float32 [n, 4, 4]: a figure-eight through the synthetic room with a
    gentle height bob, the gaze sweeping the walls ahead."""
    hx, hy, hz = (float(v) for v in half)
    t = 2.0 * np.pi * np.arange(n_frames) / n_frames
    eye = np.stack([
        0.55 * hx * np.sin(t + 0.35 * np.sin(2 * t)),
        0.16 * hy * np.sin(3 * t) - 0.08 * hy,
        0.55 * hz * np.sin(2 * t),
    ], -1)
    phi = t * 3.0 + 0.5
    target = np.stack([
        0.85 * hx * np.cos(phi),
        0.28 * hy * np.sin(1.7 * phi + 1.0) + 0.22 * hy,
        0.85 * hz * np.sin(phi),
    ], -1)
    return np.stack([_look_at(eye[k], target[k]) for k in range(n_frames)]).astype(np.float32)
