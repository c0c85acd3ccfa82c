"""Workspace GUI assets (thumbnails, floor plans).

Counterpart of `nerf_workspaces_explorer_tpu/app/assets.py`: the same
placeholder arrays, byte for byte, written as PNG by the port's own codec
(`utils.png`) where the JAX package writes them with imageio.

The reference ships per-workspace JPG assets
(application/workspaces/office_*/{thumbnail,floor_plan,
floor_plan_coordinate_systems}.jpg — SURVEY.md component 20). Those are
scene photographs that belong with the dataset; when they are absent this
module generates labeled placeholder images so the application runs
end-to-end, and real assets dropped into `assets/workspaces/<office>/`
take precedence.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_workspaces_explorer_tpu_torch.data.replica import OFFICE_TO_REPLICA_SCENE
from nerf_workspaces_explorer_tpu_torch.utils.png import write_png


def _label_pixels(text: str) -> np.ndarray:
    """Tiny 5x4-per-char bitmap font for placeholder labels (A-Z, space)."""
    font = {
        "A": ["0110", "1001", "1111", "1001", "1001"],
        "B": ["1110", "1001", "1110", "1001", "1110"],
        "C": ["0111", "1000", "1000", "1000", "0111"],
        "D": ["1110", "1001", "1001", "1001", "1110"],
        "E": ["1111", "1000", "1110", "1000", "1111"],
        "G": ["0111", "1000", "1011", "1001", "0111"],
        "I": ["1110", "0100", "0100", "0100", "1110"],
        "K": ["1001", "1010", "1100", "1010", "1001"],
        "L": ["1000", "1000", "1000", "1000", "1111"],
        "N": ["1001", "1101", "1011", "1001", "1001"],
        "O": ["0110", "1001", "1001", "1001", "0110"],
        "R": ["1110", "1001", "1110", "1010", "1001"],
        "T": ["1111", "0100", "0100", "0100", "0100"],
        "V": ["1001", "1001", "1001", "0110", "0110"],
        "W": ["1001", "1001", "1011", "1101", "1001"],
        "X": ["1001", "1001", "0110", "1001", "1001"],
        "Y": ["1001", "0110", "0100", "0100", "0100"],
        "Z": ["1111", "0001", "0110", "1000", "1111"],
        " ": ["0000", "0000", "0000", "0000", "0000"],
    }
    rows = []
    for r in range(5):
        row = []
        for ch in text.upper():
            glyph = font.get(ch, font[" "])
            row.extend(int(b) for b in glyph[r])
            row.append(0)
        rows.append(row)
    return np.asarray(rows, dtype=np.uint8)


def make_floor_plan(name: str, height: int = 600, width: int = 600) -> np.ndarray:
    """Placeholder floor plan: light background, wall border, room grid."""
    img = np.full((height, width, 3), 235, dtype=np.uint8)
    img[:8], img[-8:], img[:, :8], img[:, -8:] = 60, 60, 60, 60
    # A couple of interior "walls".
    img[height // 2 - 3 : height // 2 + 3, 8 : width // 2] = 120
    img[height // 4 :, 2 * width // 3 - 3 : 2 * width // 3 + 3] = 120
    label = _label_pixels(name)
    scale = 6
    label = np.kron(label, np.ones((scale, scale), dtype=np.uint8))
    lh, lw = label.shape
    y0, x0 = 30, 30
    region = img[y0 : y0 + lh, x0 : x0 + lw]
    region[label[: region.shape[0], : region.shape[1]] > 0] = 30
    return img


def make_thumbnail(name: str, seed: int, height: int = 300, width: int = 400) -> np.ndarray:
    """Placeholder thumbnail: colored gradient + label."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(60, 180, size=3)
    yy = np.linspace(0, 1, height)[:, None, None]
    xx = np.linspace(0, 1, width)[None, :, None]
    img = (base + 60 * yy + 40 * xx).clip(0, 255).astype(np.uint8)
    img = np.broadcast_to(img, (height, width, 3)).copy()
    label = _label_pixels(name)
    scale = 4
    label = np.kron(label, np.ones((scale, scale), dtype=np.uint8))
    lh, lw = label.shape
    y0 = height // 2 - lh // 2
    x0 = max(10, width // 2 - lw // 2)
    region = img[y0 : y0 + lh, x0 : x0 + lw]
    region[label[: region.shape[0], : region.shape[1]] > 0] = 255
    return img


def make_coordinate_systems_plan(
    name: str, height: int = 600, width: int = 600
) -> np.ndarray:
    """Placeholder for the reference's per-office
    `floor_plan_coordinate_systems.jpg` (SURVEY.md component 20): the floor
    plan annotated with the world-frame axes the click-to-COORD calibration
    uses — X axis arrow down the plan, Z axis arrow across (the relative
    click coordinates map onto the x'/z' extents; app/workspace.py)."""
    img = make_floor_plan(name, height, width)
    ox, oy = 40, height - 40  # axes origin: bottom-left inside the walls
    # Z axis: horizontal arrow.
    img[oy - 2 : oy + 2, ox : width - 60] = (180, 30, 30)
    img[oy - 8 : oy + 8, width - 68 : width - 60] = (180, 30, 30)
    # X axis: vertical arrow (up the plan).
    img[60:oy, ox - 2 : ox + 2] = (30, 30, 180)
    img[52:60, ox - 8 : ox + 8] = (30, 30, 180)
    for label, (ly, lx) in (("Z", (oy - 30, width - 58)), ("X", (30, ox + 14))):
        glyph = np.kron(_label_pixels(label), np.ones((4, 4), dtype=np.uint8))
        region = img[ly : ly + glyph.shape[0], lx : lx + glyph.shape[1]]
        region[glyph[: region.shape[0], : region.shape[1]] > 0] = 30
    return img


def ensure_mapping_file(assets_dir: str) -> str:
    """Write the office <-> Replica scene mapping file in the reference's
    format (application/workspaces/mapping.txt:1-6); the mapping itself
    lives in data/replica.py as the loader's single source of truth."""
    path = os.path.join(assets_dir, "mapping.txt")
    if not os.path.exists(path):
        os.makedirs(assets_dir, exist_ok=True)
        lines = ["Replica -> NeRF-Workspaces-Explorer", "-" * 35]
        lines += [
            f"{scene} -> {office}"
            for office, scene in OFFICE_TO_REPLICA_SCENE.items()
        ]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return path


def ensure_assets(workspace) -> dict:
    """Return paths for 'thumbnail', 'floor_plan', and
    'floor_plan_coordinate_systems', generating placeholders under the
    workspace folder when real assets are missing."""
    folder = workspace.folder_path
    os.makedirs(folder, exist_ok=True)
    paths = {}
    thumb = os.path.join(folder, "thumbnail.jpg")
    plan = os.path.join(folder, "floor_plan.jpg")
    coords = os.path.join(folder, "floor_plan_coordinate_systems.jpg")
    h, w = workspace.floor_plan_scale
    if not os.path.exists(thumb):
        thumb = os.path.join(folder, "thumbnail.png")
        if not os.path.exists(thumb):
            write_png(thumb, make_thumbnail(workspace.name, seed=hash(workspace.name) % 1000))
    if not os.path.exists(plan):
        plan = os.path.join(folder, "floor_plan.png")
        if not os.path.exists(plan):
            write_png(plan, make_floor_plan(workspace.name, h, w))
    if not os.path.exists(coords):
        coords = os.path.join(folder, "floor_plan_coordinate_systems.png")
        if not os.path.exists(coords):
            write_png(coords, make_coordinate_systems_plan(workspace.name, h, w))
    ensure_mapping_file(os.path.dirname(folder))
    paths["thumbnail"] = thumb
    paths["floor_plan"] = plan
    paths["floor_plan_coordinate_systems"] = coords
    return paths
