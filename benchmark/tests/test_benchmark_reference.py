"""The frozen copies agree with the program at a small size on the CPU
(this test imports both; the reference itself imports nothing of the
program)."""

import dataclasses

import numpy as np
import pytest
import torch

from harness import frames, manifest, steps
from reference import nerf, poses

from nerf_workspaces_explorer_tpu_torch.app.workspace import WORKSPACE_CLASSES
from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
from nerf_workspaces_explorer_tpu_torch.core.config import load_config
from nerf_workspaces_explorer_tpu_torch.data.synthetic import walkthrough_poses
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

MAN = manifest.manifest()


@pytest.mark.parametrize("office", sorted(poses.OFFICES))
def test_click_poses(office):
    space = WORKSPACE_CLASSES[office](renderer=object.__new__(NeRFRenderer))
    for rx, ry, hor, ver in ((0.3, 0.7, 30, -30), (0.55, 0.45, 270, 0), (0.8, 0.2, 120, 30)):
        init, coord = space.transform_relative_coordinates(rx, ry, hor, ver)
        want = poses_from_coordinates(init, [coord])[0]
        np.testing.assert_allclose(poses.click_pose(office, rx, ry, hor, ver), want, atol=2e-6)


def test_walkthrough_poses():
    np.testing.assert_allclose(poses.walkthrough_poses(900), walkthrough_poses(900), atol=1e-6)


def _cfg(depth_range, h=12, w=16):
    cfg = load_config(office_name="tokyo")
    return dataclasses.replace(
        cfg, experiment=dataclasses.replace(cfg.experiment, image_width=w, image_height=h),
        rendering=dataclasses.replace(cfg.rendering, depth_range=tuple(depth_range)),
        inference=dataclasses.replace(cfg.inference, chunk=h * w))


@pytest.mark.parametrize("config_name, stride", [("nerf-hier-8x256", 1), ("turbo-6x192", 1), ("turbo-6x192", 4)])
def test_frame_against_the_programs_float32_path(config_name, stride):
    """The reference's uint8 frame equals the program's float32 parity
    path's where placement is exact; with the turbo preset's stride-4
    placement (which only the program's fused path runs), the same path's
    frame at stride 1 and 4 straddles the reference's at each."""
    config = manifest.load_config(MAN, config_name)
    serve = config["serve"]
    cfg = _cfg(serve["depth_range"])
    pose = poses.walkthrough_poses(900)[200] if serve["preset"] == "turbo" else poses.click_pose(
        "office_tokyo", 0.5, 0.6, 30, 0)
    kw = {} if serve["preset"] != "turbo" else {"proposal_subsample": stride}
    prog = NeRFRenderer("tokyo", f"{manifest.ROOT}/{serve['checkpoint']}", config=cfg,
                        precision="parity" if stride == 1 else "fast", preset=serve["preset"], device="cpu", **kw)
    prog.initialize_models()
    got = prog.render_pose_uint8(pose).numpy().astype(int)
    nets = frames.reference_nets(config, "cpu")
    mix = {"height": 12, "width": 16}
    spec = frames.reference_spec(config, mix)
    spec["stride"] = stride
    ref = nerf.render_frame(nets, pose, spec, torch.device("cpu"))
    d = np.abs(got - ref.rgb8.numpy().astype(int))
    if stride == 1:
        assert d.max() <= 1, d.max()
    else:
        # bf16 products against float32 on 4-pixel-wide blocks of a 16x12 frame
        assert d.mean() < 4.0
    assert 0 < ref.fine_needed <= ref.fine_rays * spec["n_importance"] + (spec["n_samples"] if spec["merge"] else 0) * ref.fine_rays
    assert 0 < ref.density_needed <= ref.density_rays * spec["n_samples"]


@pytest.mark.parametrize("name, mix", [("hier-train-k10", dict(width=16, height=12, n_frames=40, steps_per_call=3))])
def test_training_steps_against_the_programs_float32_field(name, mix):
    """The reference's steps from the same weights and draws equal the
    program's steps on its plain float32 field: every loss, the parameters'
    change and Adam's first moment at the median leaf."""
    entry = manifest.workload_entry(MAN, name)
    config = manifest.load_config(MAN, entry["config"])
    config = dict(config, train=dict(config["train"], n_rays=32, field_impl="plain"))
    mix = dict(manifest.load_traffic(entry["traffic"]), **mix)
    gen = manifest.generator(mix["kind"])
    torch.set_num_threads(4)
    sc = steps.StepCell(config, mix, manifest.load_cell(name), gen, "cpu", 2**31 + 79)
    st = sc.stretch(from_init=True)
    rays, rgbs = gen.reference_inputs(sc.system, mix, sc.device)
    got = steps.judge_stretch(st, sc.system["init"], rays, rgbs, config, mix, 2**31 + 79)
    assert got["loss_gap"] < 1e-5, got
    assert got["median_change_gap"] < 1e-3 and got["median_moment_gap"] < 1e-4, got
