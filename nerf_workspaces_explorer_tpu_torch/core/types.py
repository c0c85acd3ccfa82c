"""Typed coordinate descriptors.

Parity target: reference utils/data_descriptors.py:3-23 (HW / XYZ / COORD
namedtuples with defaults and formatted __str__). Implemented as
typing.NamedTuple so instances are hashable and immutable.
"""

from typing import NamedTuple


class HW(NamedTuple):
    """Height/width pair (reference utils/data_descriptors.py:3-8)."""

    h: int = 0
    w: int = 0

    def __str__(self) -> str:
        return f"h = {self.h}, w = {self.w}"

    def __ge__(self, other) -> bool:  # type: ignore[override]
        return (self.h >= other.h) and (self.w >= other.w)

    def __le__(self, other) -> bool:  # type: ignore[override]
        return (self.h <= other.h) and (self.w <= other.w)


class XYZ(NamedTuple):
    """3D point (reference utils/data_descriptors.py:10-13)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def __str__(self) -> str:
        return f"x = {self.x}, y = {self.y}, z = {self.z}"


class COORD(NamedTuple):
    """Camera position + Euler orientation in degrees
    (reference utils/data_descriptors.py:15-23)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0

    def __str__(self) -> str:
        return (
            f"x = {self.x:.3f}, \n"
            f"y = {self.y:.3f}, \n"
            f"z = {self.z:.3f}, \n"
            f"pitch (rotation over X axis) = {self.pitch:.3f}, \n"
            f"yaw (rotation over Y axis) = {self.yaw:.3f}, \n"
            f"roll (rotation over Z axis) = {self.roll:.3f}"
        )
