"""PyQt5 GUI of the port: landing page + workspace explorer.

Counterpart of `nerf_workspaces_explorer_tpu/app/gui_qt.py` (reference
application/app.py:18-448): the same window sizes (1000x700 landing,
1000x800 explorer), 2x2 thumbnail grid, clickable centered floor plan
emitting relative coordinates, rendered view scaled to width 700, four
camera buttons stepping 30 degrees, the same return-to-floor-plan and
return-to-landing flows, and the same progressive render (the preview, then
the full frame), synchronously on the UI thread.

Two differences from the JAX GUI, on purpose:
  - A PNG asset becomes a pixmap from the array `utils.png` decodes,
    through `QImage` and `QPixmap.fromImage`; a `.jpg` asset (the
    reference's photographs) goes through Qt's own loader. Nothing here
    needs PIL.
  - An error from `renderer.warmup()` or from the preview propagates. The
    JAX GUI swallows both (`except Exception: pass`); on the card that
    would hide a render kernel that fails to build or to launch. Only how a
    failure shows differs, not what is rendered.

Import requires PyQt5; the entry point (`python -m
nerf_workspaces_explorer_tpu_torch`) falls back to the tkinter GUI when it
is unavailable.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from PyQt5.QtCore import Qt, pyqtSignal
from PyQt5.QtGui import QColor, QFont, QImage, QPainter, QPixmap
from PyQt5.QtWidgets import (
    QGridLayout,
    QHBoxLayout,
    QLabel,
    QMainWindow,
    QPushButton,
    QVBoxLayout,
    QWidget,
)

from nerf_workspaces_explorer_tpu_torch.app.assets import ensure_assets
from nerf_workspaces_explorer_tpu_torch.app.common import CameraViewState, click_to_relative
from nerf_workspaces_explorer_tpu_torch.app.workspace import Workspace, make_workspaces
from nerf_workspaces_explorer_tpu_torch.utils.png import read_rgb

MAIN_BUTTON_STYLE = (
    "QPushButton { background-color: #4CAF50; color: white; border: none; "
    "padding: 10px; border-radius: 5px; font-weight: bold; } "
    "QPushButton:hover { background-color: #45a049; }"
)
CAMERA_BUTTON_STYLE = (
    "QPushButton { background-color: #EEC10F; color: white; border: none; "
    "padding: 10px; border-radius: 5px; font-weight: bold; } "
    "QPushButton:hover { background-color: #CDA609; }"
)


def pixmap_from_array(image: np.ndarray) -> QPixmap:
    """uint8 RGB [H, W, 3] -> QPixmap (`fromImage` copies the pixels)."""
    image = np.ascontiguousarray(image)
    height, width, channels = image.shape
    return QPixmap.fromImage(QImage(image.data, width, height, width * channels, QImage.Format_RGB888))


def load_pixmap(path: str) -> QPixmap:
    """An asset as a pixmap: a PNG through `utils.png`, else Qt's loader."""
    if path.lower().endswith(".png"):
        return pixmap_from_array(read_rgb(path))
    return QPixmap(path)


class FloorPlanImageArea(QLabel):
    """Clickable floor plan (reference app.py:417-448)."""

    left_click = pyqtSignal(float, float)

    def mousePressEvent(self, event) -> None:
        if self.pixmap():
            rel = click_to_relative(
                event.x(),
                event.y(),
                self.size().width(),
                self.size().height(),
                self.pixmap().size().width(),
                self.pixmap().size().height(),
            )
            if rel is not None:
                self.left_click.emit(*rel)
        super().mousePressEvent(event)


class _DarkWindow(QMainWindow):
    def paintEvent(self, event) -> None:
        painter = QPainter(self)
        painter.setBrush(QColor(80, 80, 90))
        painter.drawRect(0, 0, self.width(), self.height())
        super().paintEvent(event)


class LandingPage(_DarkWindow):
    def __init__(self, workspaces: Optional[List[Workspace]] = None) -> None:
        super().__init__()
        self.workspaces = workspaces if workspaces is not None else make_workspaces()
        self.setWindowTitle("Workspaces Explorer")
        self.setFixedSize(1000, 700)

        central = QWidget(self)
        layout = QVBoxLayout(central)
        self.setCentralWidget(central)
        font = QFont("Arial", 12)

        instruction = QLabel("Please select the workspace to take a detailed tour", self)
        instruction.setAlignment(Qt.AlignCenter)
        instruction.setFont(font)
        instruction.setStyleSheet("color: white;")
        layout.addWidget(instruction)

        grid = QGridLayout()
        for i, workspace in enumerate(self.workspaces):
            assets = ensure_assets(workspace)
            label = QLabel(self)
            label.setPixmap(load_pixmap(assets["thumbnail"]).scaledToWidth(300))
            label.setAlignment(Qt.AlignCenter)
            label.setStyleSheet("background-color: rgba(0, 0, 0, 50);")
            label.mousePressEvent = lambda _e, idx=i: self._open_workspace_viewer(idx)
            grid.addWidget(label, (i // 2) * 2, i % 2)

            title = QLabel(workspace.name, self)
            title.setAlignment(Qt.AlignCenter)
            title.setFont(font)
            title.setStyleSheet("color: white;")
            grid.addWidget(title, (i // 2) * 2 + 1, i % 2)
        layout.addLayout(grid)

    def _open_workspace_viewer(self, index: int) -> None:
        self.hide()
        viewer = WorkspaceExplorer(self, self.workspaces[index])
        viewer.show()


class WorkspaceExplorer(_DarkWindow):
    def __init__(self, parent: QMainWindow, workspace: Workspace) -> None:
        super().__init__(parent)
        self.workspace = workspace
        self.state = CameraViewState()
        workspace.initialize_models()
        # Pay the kernels' build and first launches here (the model-load
        # step, where a pause is expected), not on the first click.
        workspace.renderer.warmup()

        self.setWindowTitle("Workspace Details")
        self.setFixedSize(1000, 800)

        central = QWidget(self)
        self._layout = QVBoxLayout(central)
        self.setCentralWidget(central)

        back = QPushButton("Explore another workspace", self)
        back.clicked.connect(self._return_to_landing_page)
        back.setMaximumWidth(300)
        back.setStyleSheet(MAIN_BUTTON_STYLE)
        self._layout.addWidget(back, alignment=Qt.AlignCenter | Qt.AlignTop)

        self._plan_description = QLabel(f"Floor plan of the workspace '{workspace.name}'", self)
        self._plan_description.setAlignment(Qt.AlignCenter)
        self._plan_description.setFont(QFont("Arial", 12))
        self._plan_description.setStyleSheet("color: white;")
        self._layout.addWidget(self._plan_description)

        assets = ensure_assets(workspace)
        self._plan = FloorPlanImageArea(self)
        scale_h, scale_w = workspace.floor_plan_scale
        self._plan.setPixmap(load_pixmap(assets["floor_plan"]).scaled(scale_w, scale_h))
        self._plan.setAlignment(Qt.AlignCenter)
        self._plan.left_click.connect(self._floor_plan_clicked)
        self._layout.addWidget(self._plan)

        self._plan_instruction = QLabel("Click on the image for detailed in-place workspace view", self)
        self._plan_instruction.setAlignment(Qt.AlignCenter)
        self._plan_instruction.setFont(QFont("Arial", 10))
        self._plan_instruction.setStyleSheet("color: white;")
        self._layout.addWidget(self._plan_instruction)

        self._nerf_image: Optional[QLabel] = None
        self._view_widgets: list = []
        self.frame_shown: Optional[np.ndarray] = None  # the frame shown last

    def _floor_plan_clicked(self, rel_x: float, rel_y: float) -> None:
        self.state.set_position(rel_x, rel_y)
        for widget in (self._plan, self._plan_description, self._plan_instruction):
            self._layout.removeWidget(widget)
            widget.setParent(None)

        self._nerf_image = QLabel(self)
        self._nerf_image.setAlignment(Qt.AlignCenter)
        self._layout.addWidget(self._nerf_image)
        self._view_widgets = [self._nerf_image]

        hint = QLabel("Turn camera by clicking buttons bellow", self)
        hint.setAlignment(Qt.AlignCenter)
        hint.setFont(QFont("Arial", 10))
        hint.setStyleSheet("color: white;")
        self._layout.addWidget(hint)
        self._view_widgets.append(hint)

        buttons = QHBoxLayout()
        for text, action in (
            ("←", self.state.turn_left),
            ("→", self.state.turn_right),
            ("↑", self.state.turn_up),
            ("↓", self.state.turn_down),
        ):
            button = QPushButton(text, self)
            button.setMaximumWidth(200)
            button.setStyleSheet(CAMERA_BUTTON_STYLE)
            button.clicked.connect(lambda _c, a=action: self._turn(a))
            buttons.addWidget(button)
            self._view_widgets.append(button)
        self._layout.addLayout(buttons)

        back = QPushButton("Back to Floor Plan", self)
        back.clicked.connect(self._return_to_floor_plan)
        back.setMaximumWidth(200)
        back.setStyleSheet(MAIN_BUTTON_STYLE)
        self._layout.addWidget(back, alignment=Qt.AlignCenter | Qt.AlignBottom)
        self._view_widgets.append(back)

        self._render()

    def _turn(self, action) -> None:
        action()
        self._render()

    def _render(self) -> None:
        # Progressive rendering (an extension; the reference renders only the
        # full frame, app.py:323-347): the preview, painted at once, then the
        # full frame. repaint() (not processEvents) flushes the preview
        # without re-entering the event loop, so a queued click or close can
        # neither start a nested render nor destroy widgets under us.
        args = self.state.render_args()
        self._set_frame(self.workspace.render_image_preview(*args))
        self._nerf_image.repaint()
        self._set_frame(self.workspace.render_image(*args))

    def _set_frame(self, image: np.ndarray) -> None:
        self.frame_shown = image
        self._nerf_image.setPixmap(pixmap_from_array(image).scaledToWidth(700))

    def _return_to_floor_plan(self) -> None:
        self.state.reset()
        for widget in self._view_widgets:
            self._layout.removeWidget(widget)
            widget.deleteLater()
        self._view_widgets = []
        self._layout.addWidget(self._plan_description)
        self._layout.addWidget(self._plan)
        self._layout.addWidget(self._plan_instruction)
        for widget in (self._plan_description, self._plan, self._plan_instruction):
            widget.setParent(self.centralWidget())
            widget.show()

    def _return_to_landing_page(self) -> None:
        self.parent().show()
        self.close()


def run(workspaces: Optional[List[Workspace]] = None) -> None:
    import sys

    from PyQt5.QtWidgets import QApplication

    app = QApplication(sys.argv)
    landing = LandingPage(workspaces)
    landing.show()
    sys.exit(app.exec_())
