"""Workspace models: floor-plan click -> world camera pose -> rendered view.

Counterpart of `nerf_workspaces_explorer_tpu/app/workspace.py` (reference
application/workspace.py:13-196); the GUIs (`app.gui_qt`, `app.gui_tk`)
drive it. Each of the four offices hardcodes its floor-plan -> world
calibration: x'/z' extents, camera height y=-0.5, the angle between the
floor-plan axes and the Replica world axes (divided out via cos), and an
initial pitch of -90 degrees.

Reference quirks kept exactly:
  - new_york maps rel_x -> x' and rel_y -> z' (reference workspace.py:125-126)
    while the other three offices map rel_y -> x' and rel_x -> z';
  - the per-view delta COORD negates the horizontal angle (yaw=-hor_angle);
  - both x and z divide by cos(angle_diff).
"""

from __future__ import annotations

import os
from abc import ABCMeta, abstractmethod
from typing import List, Optional, Tuple

import numpy as np

from nerf_workspaces_explorer_tpu_torch.core.types import COORD, HW
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
from nerf_workspaces_explorer_tpu_torch.obs.profiler import span

PROJECT_PATH = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
FINAL_MODELS_DIR = os.path.join(PROJECT_PATH, "final_models")
ASSETS_DIR = os.path.join(PROJECT_PATH, "assets", "workspaces")


class Workspace(metaclass=ABCMeta):
    """One office: name, floor-plan scale, calibration, renderer."""

    def __init__(
        self,
        name: str,
        floor_plan_scale: HW,
        *,
        ckpt_path: Optional[str] = None,
        renderer: Optional[NeRFRenderer] = None,
        precision: str = "parity",
        preset: str = "reference",
        device: Optional[str] = None,
    ) -> None:
        self._name = name
        self._floor_plan_scale = floor_plan_scale
        self._office_name = name.replace(" ", "_").lower()
        self._folder_path = os.path.join(ASSETS_DIR, self._office_name)
        self._model_path = ckpt_path if ckpt_path is not None else _find_checkpoint(self._office_name)
        self._nerf_inference = (
            renderer
            if renderer is not None
            else NeRFRenderer(
                self._office_name, self._model_path, precision=precision,
                preset=preset, device=device,
            )
        )

    def __repr__(self) -> str:
        return self._name

    @property
    def name(self) -> str:
        return self._name

    @property
    def office_name(self) -> str:
        return self._office_name

    @property
    def folder_path(self) -> str:
        """The office's GUI assets (thumbnail, floor plans): `app.assets`."""
        return self._folder_path

    @property
    def floor_plan_scale(self) -> HW:
        return self._floor_plan_scale

    @property
    def renderer(self) -> NeRFRenderer:
        return self._nerf_inference

    @abstractmethod
    def _transform_relative_coordinates(
        self, rel_x: float, rel_y: float, hor_angle: int, ver_angle: int
    ) -> Tuple[COORD, COORD]:
        ...

    def transform_relative_coordinates(
        self, rel_x: float, rel_y: float, hor_angle: int, ver_angle: int
    ) -> Tuple[COORD, COORD]:
        """Public access to the calibration transform (also used by tests)."""
        return self._transform_relative_coordinates(rel_x, rel_y, hor_angle, ver_angle)

    def initialize_models(self, **kwargs) -> None:
        self._nerf_inference.initialize_models(**kwargs)

    def render_image(
        self, rel_x: float, rel_y: float, horizontal_angle: int, vertical_angle: int
    ) -> np.ndarray:
        """Floor-plan relative click + camera angles -> uint8 [H, W, 3]
        (reference Workspace.render_image, workspace.py:54-68); the span
        `app.render_image`."""
        with span("app.render_image"):
            init_coordinates, coordinates = self._transform_relative_coordinates(
                rel_x, rel_y, horizontal_angle, vertical_angle
            )
            # Console trace preserved from reference workspace.py:58-64.
            print(
                f"Virtual camera coordinates and orientation: \n{init_coordinates}\n"
                f"-------------------------------------\n"
                f"Virtual camera local orientation: \n"
                f"yaw (left-right): {coordinates.yaw:.3f}\n"
                f"pitch (up-down): {coordinates.pitch:.3f}\n"
                f"roll (twist): {coordinates.roll:.3f}\n"
                f"-------------------------------------------------------------"
            )
            return self._nerf_inference.render_coordinates(init_coordinates, coordinates)

    def render_image_preview(
        self, rel_x: float, rel_y: float, horizontal_angle: int, vertical_angle: int
    ) -> np.ndarray:
        """The renderer's cheap preview frame of the same click, for
        progressive rendering (JAX workspace.py:128-141). Silent: the console
        trace prints once, from the full render that follows."""
        init_coordinates, coordinates = self._transform_relative_coordinates(
            rel_x, rel_y, horizontal_angle, vertical_angle
        )
        return self._nerf_inference.render_coordinates_preview(init_coordinates, coordinates)


def _find_checkpoint(office_name: str) -> str:
    """Prefer a native .npz, fall back to the reference's torch .ckpt path."""
    npz = os.path.join(FINAL_MODELS_DIR, office_name, "model.npz")
    if os.path.exists(npz):
        return npz
    return os.path.join(FINAL_MODELS_DIR, office_name, "model.ckpt")


class _CalibratedWorkspace(Workspace):
    """The calibration transform, parametrised by class constants."""

    X_PRIM_MAX: float
    X_PRIM_MIN: float
    Z_PRIM_MAX: float
    Z_PRIM_MIN: float
    ANGLE_DIFF: float
    FIXED_Y: float = -0.5
    INIT_PITCH: float = -90.0
    SWAP_AXES: bool = False  # new_york maps rel_x -> x' instead

    def _transform_relative_coordinates(
        self, rel_x: float, rel_y: float, hor_angle: int, ver_angle: int
    ) -> Tuple[COORD, COORD]:
        u, v = (rel_x, rel_y) if self.SWAP_AXES else (rel_y, rel_x)
        x_prim = (self.X_PRIM_MIN - self.X_PRIM_MAX) * u + self.X_PRIM_MAX
        z_prim = (self.Z_PRIM_MIN - self.Z_PRIM_MAX) * v + self.Z_PRIM_MAX
        cos_diff = np.cos(self.ANGLE_DIFF / 180.0 * np.pi)
        return (
            COORD(
                x=x_prim / cos_diff, y=self.FIXED_Y, z=z_prim / cos_diff,
                yaw=0.0, pitch=self.INIT_PITCH, roll=0.0,
            ),
            COORD(
                x=0.0, y=0.0, z=0.0,
                yaw=-float(hor_angle), pitch=float(ver_angle), roll=0.0,
            ),
        )


class OfficeTokyoWorkspace(_CalibratedWorkspace):
    """Reference application/workspace.py:71-100."""

    X_PRIM_MAX, X_PRIM_MIN = 2.0, -2.0
    Z_PRIM_MAX, Z_PRIM_MIN = 1.5, -3.0
    ANGLE_DIFF = -10.0

    def __init__(self, **kwargs) -> None:
        super().__init__("Office Tokyo", HW(600, 600), **kwargs)


class OfficeNewYorkWorkspace(_CalibratedWorkspace):
    """Reference application/workspace.py:103-132 (rel_x/rel_y swapped)."""

    X_PRIM_MAX, X_PRIM_MIN = 1.8, -1.2
    Z_PRIM_MAX, Z_PRIM_MIN = 2.0, -1.6
    ANGLE_DIFF = 45.0
    SWAP_AXES = True

    def __init__(self, **kwargs) -> None:
        super().__init__("Office New York", HW(600, 800), **kwargs)


class OfficeGeneveWorkspace(_CalibratedWorkspace):
    """Reference application/workspace.py:135-164."""

    X_PRIM_MAX, X_PRIM_MIN = 1.7, -2.5
    Z_PRIM_MAX, Z_PRIM_MIN = 4.2, -2.8
    ANGLE_DIFF = 35.0

    def __init__(self, **kwargs) -> None:
        super().__init__("Office Geneve", HW(600, 1000), **kwargs)


class OfficeBelgradeWorkspace(_CalibratedWorkspace):
    """Reference application/workspace.py:167-196."""

    X_PRIM_MAX, X_PRIM_MIN = 4.7, -0.7
    Z_PRIM_MAX, Z_PRIM_MIN = 3.5, -2.3
    ANGLE_DIFF = -10.0

    def __init__(self, **kwargs) -> None:
        super().__init__("Office Belgrade", HW(600, 750), **kwargs)


WORKSPACE_CLASSES = {
    "office_tokyo": OfficeTokyoWorkspace,
    "office_new_york": OfficeNewYorkWorkspace,
    "office_geneve": OfficeGeneveWorkspace,
    "office_belgrade": OfficeBelgradeWorkspace,
}


def make_workspaces(**kwargs) -> List[Workspace]:
    """All four offices in the reference's landing-page order
    (reference application/app.py:12-15); keyword arguments go to each
    Workspace (`precision=`, `preset=`, `device=`, as main.py passes them)."""
    return [cls(**kwargs) for cls in WORKSPACE_CLASSES.values()]
