"""The port's serving leftovers on the CPU: the render CLI (single frame and
tour), the strip-pipelined frame, nan_debug's scan, the torch checkpoint
export and the convert CLI; mirrors of tests/test_render_cli.py,
tests/test_obs.py and tests/test_checkpoint.py, with the export held
against the JAX package's."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.infer import checkpoint as jckpt
from nerf_workspaces_explorer_tpu_torch.core.config import load_config
from nerf_workspaces_explorer_tpu_torch.core.types import COORD
from nerf_workspaces_explorer_tpu_torch.infer import checkpoint as ckpt
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, init_nerf_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
ROOM = os.path.join(ROOT, "assets", "bench", "room_proposal.npz")


def _cfg(h, w, depth_range=None, **rendering):
    cfg = load_config(office_name="tokyo")
    if depth_range is not None:
        rendering["depth_range"] = depth_range
    return dataclasses.replace(
        cfg,
        experiment=dataclasses.replace(cfg.experiment, image_width=w, image_height=h),
        rendering=dataclasses.replace(cfg.rendering, **rendering),
        inference=dataclasses.replace(cfg.inference, chunk=h * w),
    )


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_render_cli_single_frame(tmp_path, precision):
    """tests/test_render_cli.py:13: one PNG from random weights, coarse-only
    through the fp32 pipeline, or the fused path (its plain versions here)."""
    from nerf_workspaces_explorer_tpu_torch.cli.render import main as render_main

    extra = ["--coarse-only"] if precision == "parity" else ["--precision", "fast"]
    render_main(["--office", "tokyo", "--random-init", "--width", "32", "--height", "24", "--rel-x", "0.3",
                 "--rel-y", "0.6", "--hangle", "30", "--out", str(tmp_path / "out"), "--device", "cpu", *extra])
    files = os.listdir(tmp_path / "out")
    assert len(files) == 1 and files[0].endswith(".png")
    import imageio.v2 as imageio

    assert imageio.imread(tmp_path / "out" / files[0]).shape == (24, 32, 3)


def test_render_cli_tour_and_refusals(tmp_path):
    """tests/test_render_cli.py:156: --tour writes one PNG per view (three
    yaws and three pitches at step 90); --coarse-only refuses the fused
    path, which is coarse + fine."""
    from nerf_workspaces_explorer_tpu_torch.cli.render import main as render_main

    render_main(["--office", "tokyo", "--random-init", "--width", "16", "--height", "8", "--coarse-only", "--tour",
                 "--tour-step", "90", "--out", str(tmp_path / "tour"), "--device", "cpu"])
    assert len([f for f in os.listdir(tmp_path / "tour") if f.endswith(".png")]) == 6
    with pytest.raises(SystemExit):
        render_main(["--coarse-only", "--precision", "int8", "--device", "cpu"])


def test_strip_frame_matches_blocking():
    """tests/test_render_cli.py:293: strips are the full frame's pinhole grid
    with cy shifted, so on the parity path the pipelined frame is
    byte-identical to the blocking one for every strip count dividing the
    height; 5 does not divide 12. (The fused path's strips are byte-equal
    on the card at eps 0, tests/test_torch_gpu.py; its plain versions here
    batch their matrix products by the ray count, which moves bf16
    roundings.)"""
    r = NeRFRenderer("tokyo", HIER, config=_cfg(12, 16), precision="parity", device="cpu")
    r.initialize_models()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.2, 0.1]
    blocking = r.render_pose_uint8(pose).numpy()
    assert r._pick_n_strips() == 6  # 12 rows, stride 1
    assert blocking.std() > 0
    for n in (2, 3, 6, None):
        piped = r.render_pose_uint8_pipelined(pose, n_strips=n)
        assert piped.shape == (12, 16, 3) and piped.dtype == np.uint8
        np.testing.assert_array_equal(piped, blocking)
    with pytest.raises(ValueError, match="stride-1-aligned"):
        r.render_pose_uint8_pipelined(pose, n_strips=5)


def test_strip_frame_keeps_the_placement_lattice():
    """tests/test_render_cli.py:326: at the fast preset with a proposal net
    the placement runs on a stride-4 lattice, so strips are multiples of 4
    rows: 24 rows split in 6, 20 rows only in 5, and 4 strips of 6 rows are
    refused. The stride-4 strips keep the blocking frame's placement
    lattice: through the plain versions, whose bf16 roundings move with the
    batch, at least 95% of the bytes are equal (byte-equal through the
    kernels at eps 0: tests/test_torch_gpu.py)."""
    r = NeRFRenderer("tokyo", ROOM, config=_cfg(24, 16, (0.1, 8.0)), precision="fast", preset="fast",
                     use_proposal=True, device="cpu")
    assert r.settings.proposal_subsample == 4
    assert r._pick_n_strips() == 6
    r.initialize_models()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, -0.5, 0.5]
    piped, blocking = r.render_pose_uint8_pipelined(pose), r.render_pose_uint8(pose).numpy()
    assert piped.shape == (24, 16, 3) and piped.dtype == np.uint8
    assert (piped == blocking).mean() >= 0.95
    with pytest.raises(ValueError, match="stride-4-aligned"):
        r.render_pose_uint8_pipelined(pose, n_strips=4)
    r20 = NeRFRenderer("tokyo", ROOM, config=_cfg(20, 16, (0.1, 8.0)), precision="fast", preset="fast",
                       use_proposal=True, device="cpu")
    assert r20._pick_n_strips() == 5


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_nan_debug_scans_full_outputs(capsys, precision):
    """tests/test_obs.py:84 and tests/test_render_cli.py:361: with nan_debug
    the renderer renders rgb/disp/acc/depth, scans each and prints the
    reference's message for a poisoned rgb head; without it, nothing."""
    cfg = _cfg(4, 4, n_samples=8, n_importance=8)
    init, view = COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0), COORD()

    def renderer(nan_debug, poison):
        r = NeRFRenderer("tokyo", config=cfg, precision=precision, nan_debug=nan_debug, device="cpu")
        r.initialize_models(allow_random_init=True)
        if poison:
            tree = {k: {n: v for n, v in net.items()} for k, net in r.params.items()}
            tree["fine"]["rgb"] = {"w": tree["fine"]["rgb"]["w"] * float("nan"), "b": tree["fine"]["rgb"]["b"]}
            r.set_params(tree)
        return r

    frame = renderer(True, False).render_coordinates(init, view)
    assert frame.shape == (4, 4, 3) and frame.dtype == np.uint8
    assert "[Numerical Error]" not in capsys.readouterr().out
    full = renderer(True, False)._render_batch([np.eye(4, dtype=np.float32)], full=True)
    assert set(full) >= {"rgb_fine", "disp_fine", "acc_fine", "depth_fine"}
    renderer(True, True).render_coordinates(init, view)
    assert "[Numerical Error] rgb_fine contains NaN or inf." in capsys.readouterr().out
    renderer(False, True).render_coordinates(init, view)
    assert "[Numerical Error]" not in capsys.readouterr().out


def test_scan_and_anomaly_switch():
    from nerf_workspaces_explorer_tpu_torch.obs.debug import enable_nan_debugging, scan_outputs_finite

    assert scan_outputs_finite({"a": torch.ones(2), "b": np.zeros(2), "c": None}) == []
    with pytest.raises(FloatingPointError, match="x"):
        scan_outputs_finite({"x": torch.tensor([np.inf])}, raise_on_error=True)
    enable_nan_debugging()
    assert torch.is_anomaly_enabled()
    enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


@pytest.fixture(scope="module")
def params():
    """Small coarse+fine trees of numpy arrays, shared by both packages."""
    spec = NerfMLPSpec(depth=2, width=32, skips=())
    g = torch.Generator().manual_seed(0)
    return {k: ckpt._unflatten({p: a for p, a in ckpt._flatten(init_nerf_params(g, spec))}) for k in ("coarse",
                                                                                                       "fine")}


def _trees_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


@pytest.mark.parametrize("underscore", [True, False])
def test_state_dict_matches_jax(params, underscore):
    """tests/test_checkpoint.py:92: the reference layout ([out, in], `_`
    prefix or not), key for key and bit for bit the JAX package's."""
    mine = ckpt.params_to_torch_state_dict(params["coarse"], underscore=underscore)
    ref = jckpt.params_to_torch_state_dict(params["coarse"], underscore=underscore)
    assert list(mine) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), err_msg=k)
    assert mine[("_" if underscore else "") + "pts_linears.0.weight"].shape == (32, 63)
    _trees_equal(params["coarse"], ckpt.torch_state_dict_to_params(mine))
    rgb = {n: torch.from_numpy(np.asarray(a)) for n, a in params["fine"]["rgb"].items()}  # tensor leaves too
    assert ckpt.params_to_torch_state_dict({**params["fine"], "rgb": rgb})["_rgb_linear.weight"].shape == (3, 16)


def test_torch_export_and_convert_cli(tmp_path, params):
    """tests/test_checkpoint.py:104: the exported .ckpt loads in both
    packages; .ckpt -> .npz -> .ckpt through the convert CLI keeps the
    weights and the step."""
    from nerf_workspaces_explorer_tpu_torch.cli.convert import main as convert_main

    path = str(tmp_path / "export.ckpt")
    ckpt.save_torch_checkpoint(path, params["coarse"], params["fine"], step=42)
    for load in (ckpt.load_torch_checkpoint, jckpt.load_torch_checkpoint):
        coarse, fine, step = load(path)
        assert step == 42
        _trees_equal(params["coarse"], coarse)
        _trees_equal(params["fine"], fine)
    npz, back = str(tmp_path / "m.npz"), str(tmp_path / "m2.ckpt")
    convert_main([path, npz])
    convert_main([npz, back])
    coarse, fine, step = ckpt.load_torch_checkpoint(back)
    assert step == 42
    _trees_equal(params["fine"], fine)
    jparams, jstep, _, _ = jckpt.load_checkpoint(npz)
    assert jstep == 42
    _trees_equal(params["coarse"], jparams["coarse"])
    with pytest.raises(SystemExit):
        convert_main([npz, str(tmp_path / "m.pt")])
