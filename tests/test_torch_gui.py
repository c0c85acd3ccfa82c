"""The port's GUIs (`app/gui_qt.py`, `app/gui_tk.py`) executed headless
against the duck-typed toolkits of tests/fake_toolkits.py, on a tiny CPU
renderer: the flows of tests/test_gui_exec.py (landing, explorer, floor-plan
click, progressive render, camera turns, both back flows, the plan's signal
math, stale frames dropped), every installed frame held equal to
`Workspace.render_image` of the same click, and the failures that the JAX
GUIs swallow shown: a warmup or preview error propagates, and a worker's
exception is raised on the UI thread."""

import importlib
import os
import queue
import sys
import threading

import numpy as np
import pytest
import torch

# tests/ is on the path under pytest (a test directory without
# __init__.py); `tests.fake_toolkits` would lose to an installed `tests`.
from fake_toolkits import QtEvent, TkEvent, TkRoot, install_fake_pyqt5, make_fake_tk, restore_modules

from nerf_workspaces_explorer_tpu_torch.app import workspace as ws

torch.set_num_threads(2)

TIMEOUT = 60.0


def tiny_workspace(precision="parity"):
    """Office Tokyo on a CPU renderer at 16x8: random 8x256 nets at 4+4
    samples (parity), or the in-repo synth_hier checkpoint through the
    kernels' plain versions (fast)."""
    from nerf_workspaces_explorer_tpu_torch.core.config import (
        ExperimentConfig,
        FrameworkConfig,
        InferenceConfig,
        RenderingConfig,
    )
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    if precision == "parity":
        cfg = FrameworkConfig(
            experiment=ExperimentConfig(image_width=16, image_height=8),
            rendering=RenderingConfig(n_samples=4, n_importance=4, num_freqs_3d=6, num_freqs_2d=2),
            inference=InferenceConfig(chunk=128),  # the frame's rays: the stock chunk pads to 32k
        )
        renderer = NeRFRenderer("office_tokyo", None, config=cfg, device="cpu")
    else:
        cfg = FrameworkConfig(experiment=ExperimentConfig(image_width=16, image_height=8),
                              inference=InferenceConfig(chunk=128))
        renderer = NeRFRenderer("office_tokyo", ws.PROJECT_PATH + "/assets/bench/synth_hier.npz", config=cfg,
                                precision=precision, device="cpu")
    workspace = ws.OfficeTokyoWorkspace(renderer=renderer)
    # As the entry point's --random-init: the explorer's own bare
    # initialize_models() call then succeeds.
    original = workspace.initialize_models
    workspace.initialize_models = lambda: original(allow_random_init=True)
    return workspace


@pytest.fixture(autouse=True)
def assets_in_tmp(monkeypatch, tmp_path):
    """Placeholders go to tmp_path, not the repo's assets/."""
    monkeypatch.setattr(ws, "ASSETS_DIR", str(tmp_path / "workspaces"))


# --------------------------------------------------------------------- #
# Qt
# --------------------------------------------------------------------- #

NAME_QT = "nerf_workspaces_explorer_tpu_torch.app.gui_qt"


@pytest.fixture
def gui_qt():
    previous = install_fake_pyqt5()
    saved = sys.modules.pop(NAME_QT, None)
    try:
        module = importlib.import_module(NAME_QT)
        # Every QImage handed to Qt, to hold the pixels against the render.
        images = []
        qpixmap = sys.modules["PyQt5.QtGui"].QPixmap
        from_image = qpixmap.fromImage
        qpixmap.fromImage = staticmethod(lambda image: images.append(image) or from_image(image))
        module.images = images
        yield module
    finally:
        qpixmap.fromImage = staticmethod(from_image)
        sys.modules.pop(NAME_QT, None)
        if saved is not None:
            sys.modules[NAME_QT] = saved
        restore_modules(previous)


def _qt_buttons(explorer):
    return {w.text(): w for w in explorer._view_widgets if hasattr(w, "click")}


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_gui_qt_full_flow(gui_qt, precision):
    workspace = tiny_workspace(precision)
    landing = gui_qt.LandingPage([workspace])
    assert landing._size == (1000, 700)
    landing.paintEvent(None)
    thumb = gui_qt.images[-1]  # the thumbnail, from the decoded PNG placeholder
    assert (thumb.width(), thumb.height()) == (400, 300)

    landing._open_workspace_viewer(0)
    assert not landing.isVisible()
    explorer = gui_qt.WorkspaceExplorer(landing, workspace)
    assert explorer._size == (1000, 800)
    assert explorer._plan.pixmap().size().width() == 600

    def check_frame():
        """The last QImage handed to Qt is the full frame of the state's
        click, byte for byte; the one before it is the preview."""
        want = workspace.render_image(*explorer.state.render_args())
        np.testing.assert_array_equal(explorer.frame_shown, want)
        full, preview = gui_qt.images[-1], gui_qt.images[-2]
        assert full.data == want.tobytes() and (full.width(), full.height()) == (16, 8)
        assert preview.data == workspace.render_image_preview(*explorer.state.render_args()).tobytes()
        assert explorer._nerf_image.pixmap().size().width() == 700

    explorer._plan.mousePressEvent(QtEvent(300, 150))
    assert explorer.state.render_args() == (0.5, 0.25, 0, 0)
    check_frame()

    outside = gui_qt.WorkspaceExplorer(landing, workspace)
    outside._plan.mousePressEvent(QtEvent(-10, -10))
    assert outside._nerf_image is None

    buttons = _qt_buttons(explorer)
    for text, args in [("←", (-30, 0)), ("↑", (-30, 30)), ("→", (0, 30)), ("↓", (0, 0))]:
        n_images = len(gui_qt.images)
        buttons[text].click()
        assert explorer.state.render_args()[2:] == args
        assert len(gui_qt.images) == n_images + 2  # a preview, then the full frame
        check_frame()

    explorer._return_to_floor_plan()
    assert explorer.state.render_args() == (0.0, 0.0, 0, 0)
    assert explorer._view_widgets == [] and explorer._plan in explorer._layout.items
    explorer._return_to_landing_page()
    assert landing.isVisible() and not explorer.isVisible()


def test_gui_qt_floorplan_signal_math(gui_qt):
    from PyQt5.QtGui import QPixmap

    area = gui_qt.FloorPlanImageArea(None)
    area.setPixmap(QPixmap(_size=(100, 50)))
    area.resize(200, 100)
    hits = []
    area.left_click.connect(lambda x, y: hits.append((x, y)))
    for x, y in [(50, 25), (100, 50), (10, 10), (149, 74), (150, 75)]:
        area.mousePressEvent(QtEvent(x, y))
    assert hits == [(0.0, 0.0), (0.5, 0.5), (0.99, 0.98)]


def test_gui_qt_errors_propagate(gui_qt):
    workspace = tiny_workspace()
    landing = gui_qt.LandingPage([workspace])

    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed")

    original = workspace.renderer.warmup
    workspace.renderer.warmup = broken
    with pytest.raises(RuntimeError, match="kernel failed"):
        gui_qt.WorkspaceExplorer(landing, workspace)
    workspace.renderer.warmup = original
    explorer = gui_qt.WorkspaceExplorer(landing, workspace)
    workspace.render_image_preview = broken
    with pytest.raises(RuntimeError, match="kernel failed"):
        explorer._plan.mousePressEvent(QtEvent(300, 300))


def test_gui_qt_loads_png_assets_through_qimage(gui_qt, tmp_path):
    from nerf_workspaces_explorer_tpu_torch.utils.png import write_png

    image = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    write_png(str(tmp_path / "a.png"), image)
    gui_qt.load_pixmap(str(tmp_path / "a.png"))
    assert gui_qt.images[-1].data == image.tobytes()
    # A .jpg goes to Qt's own loader (the fake's reads its size with PIL).
    from PIL import Image

    Image.fromarray(image).save(str(tmp_path / "a.jpg"))
    pixmap = gui_qt.load_pixmap(str(tmp_path / "a.jpg"))
    assert pixmap.path.endswith("a.jpg") and pixmap.size().width() == 6


# --------------------------------------------------------------------- #
# Tk
# --------------------------------------------------------------------- #


class PPMPhoto:
    """Stands in for tk.PhotoImage(data=<PPM bytes>, format="PPM")."""

    def __init__(self, data, format):
        assert format == "PPM"
        magic, size, maxval, pixels = data.split(b"\n", 3)
        assert magic == b"P6" and maxval == b"255"
        self.width, self.height = map(int, size.split())
        self.pixels = np.frombuffer(pixels, np.uint8).reshape(self.height, self.width, 3)


class QueuedRoot(TkRoot):
    """A root whose after() queues, as Tk's does: callbacks run when the UI
    thread pumps, not on the worker thread that posted them."""

    def __init__(self):
        super().__init__()
        self.queue = queue.Queue()

    def after(self, _ms, callback):
        self.queue.put(callback)

    def pump(self, until, timeout=TIMEOUT):
        """Run posted callbacks on this thread until `until()` holds."""
        import time

        deadline = time.time() + timeout
        while not until():
            self.queue.get(timeout=max(0.0, deadline - time.time()))()


@pytest.fixture
def gui_tk(monkeypatch):
    module = importlib.import_module("nerf_workspaces_explorer_tpu_torch.app.gui_tk")
    fake_tk = make_fake_tk()
    fake_tk.PhotoImage = PPMPhoto
    monkeypatch.setattr(module, "tk", fake_tk)
    monkeypatch.setattr(module, "BTN_MAIN", {**module.BTN_MAIN, "relief": fake_tk.FLAT})
    monkeypatch.setattr(module, "BTN_CAMERA", {**module.BTN_CAMERA, "relief": fake_tk.FLAT})
    return module


def _open(gui_tk, workspace, root=None):
    root = root if root is not None else gui_tk.tk.Tk()
    landing = gui_tk.LandingPage(root, [workspace])
    thumb = root.find(lambda w: "<Button-1>" in w.bindings)[0]
    thumb.bindings["<Button-1>"](TkEvent(10, 10))
    plan = [w for w in root.find(lambda w: "<Button-1>" in w.bindings) if w is not thumb][0]
    return root, landing, plan, plan.bindings["<Button-1>"].__self__


def _button(root, text):
    return root.find(lambda w: w.kwargs.get("text") == text and not w.destroyed)[0]


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_gui_tk_full_flow(gui_tk, precision):
    workspace = tiny_workspace(precision)
    root = QueuedRoot()
    root, landing, plan, explorer = _open(gui_tk, workspace, root)
    assert len(landing._photos) == 1
    assert (landing._photos[0].width, landing._photos[0].height) == (300, 225)  # a 400x300 thumbnail fit in 300
    assert not landing.frame.packed and root._geometry == "1000x800"
    assert plan.winfo_width() == 600 and plan.winfo_height() == 600

    def request(action):
        seq = explorer._render_seq
        action()
        worker_seq = explorer._render_seq
        assert worker_seq == seq + 1
        installed = []
        original = explorer._install_frame
        explorer._install_frame = lambda image: installed.append(image) or original(image)
        root.pump(lambda: len(installed) == 2)
        explorer._install_frame = original
        args = explorer.state.render_args()
        np.testing.assert_array_equal(installed[0], workspace.render_image_preview(*args))
        want = workspace.render_image(*args)
        np.testing.assert_array_equal(installed[1], want)
        np.testing.assert_array_equal(explorer.frame_shown, want)
        shown = explorer._view_photo
        assert (shown.width, shown.height) == (700, 350)
        np.testing.assert_array_equal(shown.pixels, gui_tk.resized(want, 700, 350))

    request(lambda: plan.bindings["<Button-1>"](TkEvent(300, 150)))
    assert explorer.state.render_args() == (0.5, 0.25, 0, 0)
    for text, angles in [("←", (-30, 0)), ("↑", (-30, 30)), ("→", (0, 30)), ("↓", (0, 0))]:
        request(_button(root, text).invoke)
        assert explorer.state.render_args()[2:] == angles

    _button(root, "Back to Floor Plan").invoke()
    assert explorer._view_frame is None and explorer.state.render_args() == (0.0, 0.0, 0, 0)
    assert explorer._plan_frame.packed
    plan.bindings["<Button-1>"](TkEvent(700, 10))  # outside the 600x600 plan: nothing happens
    assert explorer._view_frame is None
    _button(root, "Explore another workspace").invoke()
    assert landing.frame.packed and root._geometry == "1000x700"


def test_gui_tk_stale_frame_dropped(gui_tk):
    """Two overlapping requests: the first is mid-render when the second
    comes; only the second's frames are installed, equal to its serial
    render."""
    workspace = tiny_workspace()
    root, landing, plan, explorer = _open(gui_tk, workspace, QueuedRoot())
    explorer.state.set_position(0.5, 0.5)
    explorer._show_view_page()

    entered, release = threading.Event(), threading.Event()
    render_image = workspace.render_image

    def slow_render(*args):
        entered.set()
        assert release.wait(TIMEOUT)
        return render_image(*args)

    workspace.render_image = slow_render
    first = explorer._request_render()
    assert entered.wait(TIMEOUT)  # the first worker holds the render lock
    workspace.render_image = render_image
    explorer.state.turn_left()
    second = explorer._request_render()
    installed = []
    original = explorer._install_frame
    explorer._install_frame = lambda image: installed.append(image) or original(image)
    release.set()
    first.join(TIMEOUT)
    second.join(TIMEOUT)
    assert not first.is_alive() and not second.is_alive()
    while not root.queue.empty():
        root.queue.get()()
    want = render_image(0.5, 0.5, -30, 0)
    assert len(installed) == 2  # the second request's preview and full frame
    np.testing.assert_array_equal(installed[-1], want)
    np.testing.assert_array_equal(explorer.frame_shown, want)


def test_gui_tk_superseded_request_renders_nothing(gui_tk):
    """A request superseded before its turn at the render lock skips its
    render (the JAX GUI renders it and drops the frame)."""
    workspace = tiny_workspace()
    root, landing, plan, explorer = _open(gui_tk, workspace, QueuedRoot())
    explorer._show_view_page()
    calls = []
    render_image = workspace.render_image
    workspace.render_image = lambda *a: calls.append(a) or render_image(*a)
    with gui_tk.RENDER_LOCK:
        stale = explorer._request_render()
        fresh = explorer._request_render()
    stale.join(TIMEOUT)
    fresh.join(TIMEOUT)
    assert not stale.is_alive() and not fresh.is_alive()
    assert len(calls) == 1


def test_gui_tk_worker_error_raises_on_the_ui_thread(gui_tk):
    workspace = tiny_workspace()
    root, landing, plan, explorer = _open(gui_tk, workspace, QueuedRoot())
    explorer._show_view_page()

    def broken(*args):
        raise RuntimeError("kernel failed")

    workspace.render_image_preview = broken
    worker = explorer._request_render()
    worker.join(TIMEOUT)
    assert not worker.is_alive()
    callback = root.queue.get(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="kernel failed"):
        callback()  # on this (the UI) thread


def test_gui_tk_warmup_error_propagates(gui_tk):
    workspace = tiny_workspace()

    def broken():
        raise RuntimeError("kernel failed to build")

    workspace.renderer.warmup = broken
    with pytest.raises(RuntimeError, match="kernel failed to build"):
        _open(gui_tk, workspace)


def test_gui_tk_reads_png_assets_only(gui_tk, tmp_path):
    """`load_image` reads PNG and JPEG assets by their extension (the name
    is from when it read PNG only) and refuses any other extension; the PPM
    bytes and the display resize."""
    from PIL import Image

    from nerf_workspaces_explorer_tpu_torch.utils import jpeg, png

    image = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    png.write_png(str(tmp_path / "plan.png"), image)
    np.testing.assert_array_equal(gui_tk.load_image(str(tmp_path / "plan.png")), image)
    for name in ("thumbnail.jpg", "thumbnail.JPEG"):
        Image.fromarray(image).save(tmp_path / name, "JPEG")
        np.testing.assert_array_equal(gui_tk.load_image(str(tmp_path / name)),
                                      jpeg.read_rgb(str(tmp_path / name)))
    with pytest.raises(ValueError, match="thumbnail.bmp"):
        gui_tk.load_image(str(tmp_path / "thumbnail.bmp"))
    assert gui_tk.ppm_bytes(image) == b"P6\n7 5\n255\n" + image.tobytes()
    np.testing.assert_array_equal(gui_tk.resized(image, 7, 5), image)
    big = gui_tk.resized(image, 14, 10)
    assert big.shape == (10, 14, 3) and big.dtype == np.uint8


def test_gui_tk_installs_jpg_plan_and_thumbnail(gui_tk):
    """With the reference's `.jpg` assets in the workspace folder (which
    `ensure_assets` takes before the PNG placeholders), the Tk flow shows
    them, decoded by `utils/jpeg.py`: the landing page's thumbnail and the
    explorer's floor plan are their pixels, resized for display."""
    from PIL import Image

    from nerf_workspaces_explorer_tpu_torch.app.assets import make_floor_plan, make_thumbnail
    from nerf_workspaces_explorer_tpu_torch.utils import jpeg

    workspace = tiny_workspace()
    folder = workspace.folder_path
    os.makedirs(folder, exist_ok=True)
    h, w = workspace.floor_plan_scale
    thumb_path, plan_path = os.path.join(folder, "thumbnail.jpg"), os.path.join(folder, "floor_plan.jpg")
    Image.fromarray(make_thumbnail(workspace.name, seed=3)).save(thumb_path, "JPEG", quality=90)
    Image.fromarray(make_floor_plan(workspace.name, h // 2, w // 2)).save(plan_path, "JPEG", subsampling=2)
    root, landing, plan, explorer = _open(gui_tk, workspace, QueuedRoot())
    thumb = jpeg.read_rgb(thumb_path)
    scale = min(1.0, gui_tk.THUMBNAIL_BOX / thumb.shape[1], gui_tk.THUMBNAIL_BOX / thumb.shape[0])
    want = gui_tk.resized(thumb, round(thumb.shape[1] * scale), round(thumb.shape[0] * scale))
    np.testing.assert_array_equal(landing._photos[0].pixels, want)
    np.testing.assert_array_equal(explorer._plan_photo.pixels, gui_tk.resized(jpeg.read_rgb(plan_path), w, h))
    assert not os.path.exists(os.path.join(folder, "thumbnail.png"))
