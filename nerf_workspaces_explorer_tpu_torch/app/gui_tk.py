"""Tkinter GUI of the port: landing page + workspace explorer.

Counterpart of `nerf_workspaces_explorer_tpu/app/gui_tk.py` (reference
application/app.py:18-448): a 1000x700 landing page with a 2x2 grid of
clickable workspace thumbnails, and a 1000x800 explorer page with a
clickable floor plan that swaps to the rendered first-person view with four
camera-turn buttons (30-degree steps) and back buttons. Rendering runs on a
worker thread so a slow frame never freezes the UI, progressively (the
preview, then the full frame); frames are installed on the UI thread
through `root.after`, and a frame of a superseded request is dropped.

Differences from the JAX GUI, on purpose:
  - No PIL. PNG assets decode with `utils.png`, the reference's `.jpg`
    photographs with `utils.jpeg` (baseline JPEG); images are resized for
    display here (bilinear) and reach Tk as `tk.PhotoImage(data=<PPM
    bytes>, format="PPM")`. Any other asset, or a JPEG kind the decoder
    does not read (progressive, CMYK, ...), raises a `ValueError` that
    names it.
  - Errors show. A failure of `renderer.warmup()` propagates, and an
    exception in the worker is carried to the UI thread and raised there.
    The JAX GUI swallows the warmup's and the preview's errors (`except
    Exception: pass`) and lets the worker's die with its thread; on the card
    that would hide a render kernel that fails to build or to launch. Only
    how a failure shows differs, not what is rendered.
  - Renders run one at a time (`RENDER_LOCK`), each on the renderer's
    device: requests overlap when the user clicks faster than a frame
    renders, and the kernels' launch counters and weight-stream cache are
    module state. A request superseded before its turn renders nothing.
"""

from __future__ import annotations

import contextlib
import threading
import tkinter as tk
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_workspaces_explorer_tpu_torch.app.assets import ensure_assets
from nerf_workspaces_explorer_tpu_torch.app.common import CameraViewState, click_to_relative
from nerf_workspaces_explorer_tpu_torch.app.workspace import Workspace, make_workspaces
from nerf_workspaces_explorer_tpu_torch.utils import jpeg, png

BG = "#50505a"
BTN_MAIN = {"bg": "#4CAF50", "fg": "white", "relief": tk.FLAT, "padx": 10, "pady": 8}
BTN_CAMERA = {"bg": "#EEC10F", "fg": "white", "relief": tk.FLAT, "padx": 16, "pady": 8}
FRAME_WIDTH = 700  # the rendered view's display width (reference app.py:345)
THUMBNAIL_BOX = 300  # thumbnails fit in a 300x300 box

RENDER_LOCK = threading.Lock()


def load_image(path: str) -> np.ndarray:
    """A PNG or JPEG asset as uint8 RGB [H, W, 3], by its extension (JAX
    gui_tk.py:60, :121 open the same files with PIL)."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "png":
        return png.read_rgb(path)
    if ext in ("jpg", "jpeg"):
        return jpeg.read_rgb(path)
    raise ValueError(f"{path}: the tkinter GUI reads PNG and JPEG assets (convert it, or use --backend qt)")


def resized(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, 3] -> [height, width, 3], bilinear (antialiased when it
    shrinks), for display."""
    if image.shape[:2] == (height, width):
        return image
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def ppm_bytes(image: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] as a binary PPM, which `tk.PhotoImage` reads."""
    height, width = image.shape[:2]
    return b"P6\n%d %d\n255\n" % (width, height) + np.ascontiguousarray(image).tobytes()


def photo(image: np.ndarray):
    return tk.PhotoImage(data=ppm_bytes(image), format="PPM")


def _raise(exc: BaseException) -> None:
    raise exc


class LandingPage:
    """2x2 grid of workspace thumbnails (reference app.py:18-106)."""

    def __init__(self, root: tk.Tk, workspaces: Optional[List[Workspace]] = None) -> None:
        self.root = root
        self.workspaces = workspaces if workspaces is not None else make_workspaces()
        root.title("Workspaces Explorer")
        root.geometry("1000x700")
        root.configure(bg=BG)

        self.frame = tk.Frame(root, bg=BG)
        self.frame.pack(expand=True, fill=tk.BOTH)

        tk.Label(
            self.frame,
            text="Please select the workspace to take a detailed tour",
            font=("Arial", 12),
            fg="white",
            bg=BG,
        ).pack(pady=10)

        grid = tk.Frame(self.frame, bg=BG)
        grid.pack(expand=True)
        self._photos = []
        for i, workspace in enumerate(self.workspaces):
            image = load_image(ensure_assets(workspace)["thumbnail"])
            h, w = image.shape[:2]
            scale = min(1.0, THUMBNAIL_BOX / w, THUMBNAIL_BOX / h)
            thumb = photo(resized(image, max(1, round(w * scale)), max(1, round(h * scale))))
            self._photos.append(thumb)
            label = tk.Label(grid, image=thumb, bg="#3a3a42", cursor="hand2")
            label.grid(row=(i // 2) * 2, column=i % 2, padx=20, pady=6)
            label.bind("<Button-1>", lambda _e, idx=i: self.open_explorer(idx))
            tk.Label(grid, text=workspace.name, font=("Arial", 12), fg="white", bg=BG).grid(
                row=(i // 2) * 2 + 1, column=i % 2
            )

    def open_explorer(self, index: int) -> None:
        self.frame.pack_forget()
        WorkspaceExplorer(self.root, self, self.workspaces[index])

    def show_again(self) -> None:
        self.root.geometry("1000x700")
        self.frame.pack(expand=True, fill=tk.BOTH)


class WorkspaceExplorer:
    """Floor-plan click -> rendered view page (reference app.py:109-414)."""

    def __init__(self, root: tk.Tk, landing: LandingPage, workspace: Workspace) -> None:
        self.root = root
        self.landing = landing
        self.workspace = workspace
        self.state = CameraViewState()
        workspace.initialize_models()
        # Pay the kernels' build and first launches here (the model-load
        # step, where a pause is expected), not on the first click.
        with RENDER_LOCK:
            workspace.renderer.warmup()

        root.title("Workspace Details")
        root.geometry("1000x800")

        self.frame = tk.Frame(root, bg=BG)
        self.frame.pack(expand=True, fill=tk.BOTH)

        tk.Button(
            self.frame,
            text="Explore another workspace",
            command=self._return_to_landing,
            **BTN_MAIN,
        ).pack(pady=8)

        self._plan_frame = tk.Frame(self.frame, bg=BG)
        self._plan_frame.pack(expand=True, fill=tk.BOTH)
        tk.Label(
            self._plan_frame,
            text=f"Floor plan of the workspace '{workspace.name}'",
            font=("Arial", 12),
            fg="white",
            bg=BG,
        ).pack(pady=4)

        scale_h, scale_w = workspace.floor_plan_scale
        plan = resized(load_image(ensure_assets(workspace)["floor_plan"]), scale_w, scale_h)
        self._plan_photo = photo(plan)
        self._plan_size = (scale_w, scale_h)
        self._plan_label = tk.Label(self._plan_frame, image=self._plan_photo, bg=BG)
        self._plan_label.pack()
        self._plan_label.bind("<Button-1>", self._plan_clicked)

        tk.Label(
            self._plan_frame,
            text="Click on the image for detailed in-place workspace view",
            font=("Arial", 10),
            fg="white",
            bg=BG,
        ).pack(pady=4)

        self._view_frame = None
        self._view_photo = None
        self._render_seq = 0
        self.frame_shown: Optional[np.ndarray] = None  # the frame installed last

    # ------------------------------------------------------------------ #

    def _plan_clicked(self, event) -> None:
        rel = click_to_relative(
            event.x,
            event.y,
            self._plan_label.winfo_width(),
            self._plan_label.winfo_height(),
            self._plan_size[0],
            self._plan_size[1],
        )
        if rel is None:
            return
        self.state.set_position(*rel)
        self._show_view_page()
        self._request_render()

    def _show_view_page(self) -> None:
        self._plan_frame.pack_forget()
        self._view_frame = tk.Frame(self.frame, bg=BG)
        self._view_frame.pack(expand=True, fill=tk.BOTH)

        self._image_label = tk.Label(self._view_frame, bg=BG, text="Rendering...", fg="white")
        self._image_label.pack(expand=True)

        tk.Label(
            self._view_frame,
            text="Turn camera by clicking buttons bellow",
            font=("Arial", 10),
            fg="white",
            bg=BG,
        ).pack()

        buttons = tk.Frame(self._view_frame, bg=BG)
        buttons.pack(pady=6)
        for text, action in (
            ("←", self.state.turn_left),
            ("→", self.state.turn_right),
            ("↑", self.state.turn_up),
            ("↓", self.state.turn_down),
        ):
            tk.Button(
                buttons,
                text=text,
                command=lambda a=action: self._turn(a),
                **BTN_CAMERA,
            ).pack(side=tk.LEFT, padx=8)

        tk.Button(
            self._view_frame,
            text="Back to Floor Plan",
            command=self._return_to_floor_plan,
            **BTN_MAIN,
        ).pack(pady=8)

    def _turn(self, action) -> None:
        action()
        self._request_render()

    def _request_render(self) -> threading.Thread:
        """Render on a worker thread; install frames on the UI thread.

        Progressive: the preview lands first, then the full frame replaces
        it (an extension; the reference renders the full frame on the UI
        thread, app.py:323-347). Returns the worker."""
        args = self.state.render_args()
        self._render_seq = seq = self._render_seq + 1
        device = self.workspace.renderer.device

        def install_if_current(image):
            if self._render_seq == seq:
                self._install_frame(image)

        def work():
            try:
                # A new thread starts on device 0 and its default stream.
                on_device = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
                with RENDER_LOCK, on_device:
                    if self._render_seq != seq:
                        return
                    preview = self.workspace.render_image_preview(*args)
                    self.root.after(0, lambda: install_if_current(preview))
                    image = self.workspace.render_image(*args)
                self.root.after(0, lambda: install_if_current(image))
            except Exception as exc:  # noqa: BLE001 - raised again on the UI thread
                self.root.after(0, lambda exc=exc: _raise(exc))

        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        return worker

    def _install_frame(self, image: np.ndarray) -> None:
        if self._view_frame is None:
            return
        self.frame_shown = image
        height = int(image.shape[0] * FRAME_WIDTH / image.shape[1])
        self._view_photo = photo(resized(image, FRAME_WIDTH, height))
        self._image_label.configure(image=self._view_photo, text="")

    def _return_to_floor_plan(self) -> None:
        self.state.reset()
        if self._view_frame is not None:
            self._view_frame.destroy()
            self._view_frame = None
        self._plan_frame.pack(expand=True, fill=tk.BOTH)

    def _return_to_landing(self) -> None:
        self.frame.destroy()
        self.landing.show_again()


def run(workspaces: Optional[List[Workspace]] = None) -> None:
    root = tk.Tk()
    LandingPage(root, workspaces)
    root.mainloop()
