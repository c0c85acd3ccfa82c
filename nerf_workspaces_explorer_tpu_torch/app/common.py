"""Toolkit-independent GUI logic.

Counterpart of `nerf_workspaces_explorer_tpu/app/common.py`. The
coordinate math of the clickable floor plan (reference
application/app.py:417-448) and the explorer's camera-angle state machine
(app.py:186-214, 384-414) live here as pure functions/classes so both GUI
backends share them and tests can drive them without a display.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


def click_to_relative(
    click_x: float,
    click_y: float,
    label_w: float,
    label_h: float,
    pixmap_w: float,
    pixmap_h: float,
) -> Optional[Tuple[float, float]]:
    """Map a click inside a centered image to relative [0,1]^2 coordinates.

    Matches reference FloorPlanImageArea.mousePressEvent (app.py:427-448):
    the image is centered in its label; clicks outside it return None.
    """
    x0 = int((label_w - pixmap_w) / 2)
    y0 = int((label_h - pixmap_h) / 2)
    if x0 <= click_x < x0 + pixmap_w and y0 <= click_y < y0 + pixmap_h:
        return ((click_x - x0) / pixmap_w, (click_y - y0) / pixmap_h)
    return None


@dataclass
class CameraViewState:
    """Explorer view state: relative position + camera angles.

    The angle step is 30 degrees (reference app.py:198 — the docstrings say
    15 but the code wins, SURVEY.md §7 Q1)."""

    rel_x: float = 0.0
    rel_y: float = 0.0
    horizontal_angle: int = 0
    vertical_angle: int = 0
    angle_step: int = 30

    def set_position(self, rel_x: float, rel_y: float) -> None:
        self.rel_x = rel_x
        self.rel_y = rel_y

    def reset(self) -> None:
        self.rel_x = 0.0
        self.rel_y = 0.0
        self.reset_angles()

    def reset_angles(self) -> None:
        self.horizontal_angle = 0
        self.vertical_angle = 0

    # Button handlers (reference app.py:384-414).
    def turn_left(self) -> None:
        self.horizontal_angle -= self.angle_step

    def turn_right(self) -> None:
        self.horizontal_angle += self.angle_step

    def turn_up(self) -> None:
        self.vertical_angle += self.angle_step

    def turn_down(self) -> None:
        self.vertical_angle -= self.angle_step

    def render_args(self) -> Tuple[float, float, int, int]:
        return (self.rel_x, self.rel_y, self.horizontal_angle, self.vertical_angle)
