"""The port's toolkit-free app pieces against the JAX package's: the floor
plan's click math and the camera state (`app/common.py`), the placeholder
assets and mapping file (`app/assets.py`, byte for byte), the workspace's
asset folder, and the entry point's flags against `main.py`'s."""

import argparse
import importlib
import os

import numpy as np
import pytest

from nerf_workspaces_explorer_tpu.app import assets as jassets
from nerf_workspaces_explorer_tpu.app import common as jcommon
from nerf_workspaces_explorer_tpu_torch.app import assets, common
from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
from nerf_workspaces_explorer_tpu_torch.utils.png import read_png

NAMES = ["Office Tokyo", "Office New York", "Office Geneve", "Office Belgrade"]


def test_click_to_relative_matches_jax_on_a_grid():
    rng = np.random.default_rng(0)
    for label_w, label_h, pix_w, pix_h in [(600, 600, 600, 600), (1000, 700, 800, 600), (200, 100, 100, 50),
                                           (640, 480, 641, 100)]:
        xs = np.concatenate([np.arange(-5, label_w + 5, 7), rng.uniform(-10, label_w + 10, 50)])
        ys = np.concatenate([np.arange(-5, label_h + 5, 11), rng.uniform(-10, label_h + 10, 50)])
        for x in xs:
            for y in ys[::5]:
                args = (float(x), float(y), label_w, label_h, pix_w, pix_h)
                assert common.click_to_relative(*args) == jcommon.click_to_relative(*args)


def test_camera_view_state_matches_jax_on_button_sequences():
    rng = np.random.default_rng(1)
    actions = ["turn_left", "turn_right", "turn_up", "turn_down", "reset_angles", "reset", "set_position"]
    for _ in range(20):
        mine, ref = common.CameraViewState(), jcommon.CameraViewState()
        for name in rng.choice(actions, size=30):
            args = tuple(rng.uniform(0, 1, 2)) if name == "set_position" else ()
            getattr(mine, name)(*args)
            getattr(ref, name)(*args)
            assert mine.render_args() == ref.render_args()
    assert common.CameraViewState().angle_step == jcommon.CameraViewState().angle_step == 30


@pytest.mark.parametrize("name", NAMES)
def test_placeholders_are_jax_bytes(name):
    np.testing.assert_array_equal(assets._label_pixels(name), jassets._label_pixels(name))
    for h, w in [(600, 600), (600, 800), (600, 1000), (600, 750), (37, 53)]:
        for make in ("make_floor_plan", "make_coordinate_systems_plan"):
            mine, ref = getattr(assets, make)(name, h, w), getattr(jassets, make)(name, h, w)
            assert mine.dtype == ref.dtype == np.uint8
            np.testing.assert_array_equal(mine, ref)
    for seed in (0, 7, hash(name) % 1000):
        np.testing.assert_array_equal(assets.make_thumbnail(name, seed), jassets.make_thumbnail(name, seed))


def _workspaces(monkeypatch, tmp_path):
    """The four offices, their assets under tmp_path (not the repo's
    assets/), on CPU renderers that load nothing."""
    monkeypatch.setattr(ws, "ASSETS_DIR", str(tmp_path / "workspaces"))
    return ws.make_workspaces(device="cpu")


def test_ensure_assets_writes_placeholders_that_read_back(monkeypatch, tmp_path):
    from nerf_workspaces_explorer_tpu.app.workspace import WORKSPACE_CLASSES as JCLASSES

    for workspace in _workspaces(monkeypatch, tmp_path):
        assert workspace.folder_path == str(tmp_path / "workspaces" / workspace.office_name)
        paths = assets.ensure_assets(workspace)
        h, w = workspace.floor_plan_scale
        assert paths == {
            "thumbnail": os.path.join(workspace.folder_path, "thumbnail.png"),
            "floor_plan": os.path.join(workspace.folder_path, "floor_plan.png"),
            "floor_plan_coordinate_systems": os.path.join(workspace.folder_path, "floor_plan_coordinate_systems.png"),
        }
        np.testing.assert_array_equal(read_png(paths["floor_plan"]), jassets.make_floor_plan(workspace.name, h, w))
        np.testing.assert_array_equal(read_png(paths["floor_plan_coordinate_systems"]),
                                      jassets.make_coordinate_systems_plan(workspace.name, h, w))
        np.testing.assert_array_equal(read_png(paths["thumbnail"]),
                                      jassets.make_thumbnail(workspace.name, seed=hash(workspace.name) % 1000))
        # The JAX workspace of the same office: the same calibration scale.
        assert tuple(JCLASSES[workspace.office_name](renderer=object()).floor_plan_scale) == (h, w)
    # Real assets take precedence: a .jpg is returned, a .png kept as found.
    office = _workspaces(monkeypatch, tmp_path)[0]
    jpg = os.path.join(office.folder_path, "thumbnail.jpg")
    open(jpg, "wb").close()
    assert assets.ensure_assets(office)["thumbnail"] == jpg
    plan = os.path.join(office.folder_path, "floor_plan.png")
    before = os.path.getmtime(plan), open(plan, "rb").read()
    assets.ensure_assets(office)
    assert (os.path.getmtime(plan), open(plan, "rb").read()) == before


def test_mapping_file_text_equals_jax(tmp_path):
    mine = assets.ensure_mapping_file(str(tmp_path / "port"))
    ref = jassets.ensure_mapping_file(str(tmp_path / "jax"))
    assert open(mine).read() == open(ref).read()
    assert open(mine).read().splitlines()[2] == "office0 -> office_tokyo"


def test_folder_path_equals_jax():
    from nerf_workspaces_explorer_tpu.app import workspace as jws

    assert os.path.normpath(ws.ASSETS_DIR) == os.path.normpath(jws.ASSETS_DIR)
    for cls_name in ("OfficeTokyoWorkspace", "OfficeNewYorkWorkspace", "OfficeGeneveWorkspace",
                     "OfficeBelgradeWorkspace"):
        mine = getattr(ws, cls_name)(device="cpu")
        ref = getattr(jws, cls_name)(renderer=object())
        assert os.path.normpath(mine.folder_path) == os.path.normpath(ref.folder_path)


def test_app_package_exports_what_jax_exports():
    import nerf_workspaces_explorer_tpu.app as japp
    import nerf_workspaces_explorer_tpu_torch.app as app

    assert app.__all__ == japp.__all__
    for name in app.__all__:
        assert getattr(app, name) is getattr(ws, name)


def _main_py_parser():
    """main.py builds its parser inside main(): catch it at parse_args."""
    main_py = importlib.import_module("main")

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        main_py.main()
    except Caught as caught:
        return caught.args[0]
    finally:
        argparse.ArgumentParser.parse_args = original
    raise AssertionError("main.py did not parse arguments")


def _options(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, tuple(a.choices) if a.choices else None, type(a).__name__)
        for a in parser._actions if a.dest != "help"
    }


def test_entry_point_flags_are_main_py_flags_plus_device():
    from nerf_workspaces_explorer_tpu_torch.__main__ import build_parser

    mine, ref = _options(build_parser()), _options(_main_py_parser())
    assert mine.pop("device") == (("--device",), "cuda", None, "_StoreAction")
    assert mine == ref
    help_text = build_parser().format_help()
    for tpu_word in ("TPU", "MXU"):
        assert tpu_word not in help_text


@pytest.mark.parametrize("backend", ["tk", "qt"])
def test_entry_point_builds_workspaces_and_runs_the_backend(monkeypatch, tmp_path, backend):
    from nerf_workspaces_explorer_tpu_torch import __main__ as entry
    from fake_toolkits import install_fake_pyqt5, restore_modules

    previous = install_fake_pyqt5()
    try:
        gui = importlib.import_module(f"nerf_workspaces_explorer_tpu_torch.app.gui_{backend}")
        ran = []
        monkeypatch.setattr(gui, "run", lambda workspaces: ran.append(workspaces))
        monkeypatch.setattr(ws, "ASSETS_DIR", str(tmp_path))
        entry.main(["--backend", backend, "--device", "cpu", "--precision", "int8", "--preset", "fast",
                    "--random-init"])
    finally:
        restore_modules(previous)
        import sys

        sys.modules.pop("nerf_workspaces_explorer_tpu_torch.app.gui_qt", None)
    (workspaces,) = ran
    assert [w.name for w in workspaces] == NAMES
    renderer = workspaces[0].renderer
    assert renderer.device.type == "cpu" and renderer._precision == "int8"
    assert renderer.settings.merge_coarse is False  # the fast preset
    # --random-init: the explorer's bare initialize_models() call succeeds
    # without a checkpoint.
    workspaces[0].initialize_models()
    assert renderer.params is not None
