"""Distillation in the port (`train/distill.py`, `cli/distill.py`) against the
JAX package's on the CPU, at small sizes: the pose sets, the student's
config, the teacher's and the student's view renders, the sidecar (written
by the port, read and served by the JAX package), a short distillation run
and the CLI's flags."""

import dataclasses
import inspect
import os

import jax
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.core.config import ExperimentConfig as JExperiment
from nerf_workspaces_explorer_tpu.core.config import FrameworkConfig as JFramework
from nerf_workspaces_explorer_tpu.core.config import RenderingConfig as JRendering
from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec
from nerf_workspaces_explorer_tpu.train import distill as jd
from nerf_workspaces_explorer_tpu_torch.core.config import ExperimentConfig, FrameworkConfig, RenderingConfig
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings
from nerf_workspaces_explorer_tpu_torch.train import distill as pd

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
H, W = 12, 16
NEAR, FAR = 0.1, 6.0
# A small net at F = 5 / 2 and its render settings, in both packages.
SMALL = dict(depth=2, width=32, input_ch=33, input_ch_views=15)
SETTINGS = dict(n_samples=8, n_importance=8, num_freqs_3d=5, num_freqs_2d=2)


def _poses(n, seed=0):
    """n camera poses in the room's interior, looking around (numpy-seeded)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        yaw = rng.uniform(0.0, 2.0 * np.pi)
        fwd = np.array([np.sin(yaw), 0.1, np.cos(yaw)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        out.append(c2w)
    return np.stack(out).astype(np.float32)


def _net(key, jspec):
    """JAX params with content: a random init renders near zero density."""
    p = jax.tree.map(np.asarray, init_nerf_params(jax.random.PRNGKey(key), jspec))
    p["alpha"]["b"] = p["alpha"]["b"] + 2.0
    p["rgb"]["w"] = p["rgb"]["w"] * 8.0
    return p


def _teacher(proposal=False):
    first = ("proposal", jproposal_spec(6)) if proposal else ("coarse", JSpec(**SMALL))
    return {first[0]: _net(1, first[1]), "fine": _net(2, JSpec(**SMALL))}


def test_office_distill_poses_match_jax():
    got = pd.office_distill_poses("tokyo", grid=2, yaw_step_degrees=90)
    want = jd.office_distill_poses("tokyo", grid=2, yaw_step_degrees=90)
    assert got.shape == want.shape == (16, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_room_poses_match_jax():
    from nerf_workspaces_explorer_tpu.data import synthetic as jsyn
    from nerf_workspaces_explorer_tpu_torch.data import synthetic as syn

    half = np.asarray(jsyn.room_scene().half)
    for got, want in ((syn.room_grid_poses(half=half), jsyn.room_grid_poses(half=half)),
                      (syn.room_coverage_poses(half), jsyn.room_coverage_poses(half)),
                      (syn.room_grid_poses(), jsyn.room_grid_poses())):
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert syn.room_grid_poses(half=half).shape == (36, 4, 4)
    assert syn.room_coverage_poses(half).shape == (128, 4, 4)


def test_student_config_matches_jax():
    for kw in (dict(), dict(depth=4, net_width=128, num_freqs_3d=8, n_samples=32, n_importance=48)):
        got = pd.student_config(96, 128, near=0.1, far=8.0, **kw)
        want = jd.student_config(96, 128, near=0.1, far=8.0, **kw)
        for section in ("experiment", "training", "model", "rendering", "logging", "inference"):
            a, b = dataclasses.asdict(getattr(got, section)), dataclasses.asdict(getattr(want, section))
            assert {k: a[k] for k in b if k in a} == {k: b[k] for k in b if k in a}, section
            assert set(a) <= set(b), section


@pytest.mark.parametrize("proposal", [False, True], ids=["coarse-fine", "proposal"])
def test_render_teacher_views_match_jax(proposal):
    """The CPU path (plain fp32 pipeline) against JAX's use_pallas=False,
    from the same teacher params."""
    teacher = _teacher(proposal)
    poses = _poses(2)
    jset = JSettings(**SETTINGS, use_proposal=proposal)
    want = jd.render_teacher_views(teacher, JSpec(**SMALL), jset, poses, H, W, near=NEAR, far=FAR,
                                   use_pallas=False)
    got = pd.render_teacher_views(params_from_numpy(teacher), NerfMLPSpec(**SMALL),
                                  RenderSettings(**SETTINGS, use_proposal=proposal), poses, H, W,
                                  near=NEAR, far=FAR, device="cpu")
    assert got.shape == (2, H, W, 3) and got.dtype == np.float32
    assert got.std() > 0.01
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_render_student_views_match_jax():
    """A proposal student through the turbo preset's placement (importance
    only), against JAX's."""
    student = _teacher(proposal=True)
    poses = _poses(2, seed=1)
    want = jd.render_student_views(student, JSpec(**SMALL), JSettings(**SETTINGS, use_proposal=True,
                                                                    merge_coarse=False),
                                   poses, H, W, near=NEAR, far=FAR, use_pallas=False)
    got = pd.render_student_views(params_from_numpy(student), NerfMLPSpec(**SMALL),
                                  RenderSettings(**SETTINGS, use_proposal=True, merge_coarse=False), poses, H, W,
                                  near=NEAR, far=FAR, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_views_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pd.render_teacher_views(_teacher(), NerfMLPSpec(**SMALL), RenderSettings(**SETTINGS), _poses(1), H, W,
                                near=NEAR, far=FAR)


def test_sidecar_is_read_and_served_by_jax(tmp_path):
    """A sidecar the port writes: JAX's readers give its arrays and metadata
    (`measured_at` included), and JAX's turbo renderer (plain path) renders
    the port's parity frame to 1e-5."""
    from nerf_workspaces_explorer_tpu.infer.renderer import NeRFRenderer as JRenderer

    student = _teacher(proposal=True)
    cfg = pd.student_config(H, W, near=NEAR, far=FAR, depth=2, net_width=32, num_freqs_3d=5, n_samples=8)
    cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, num_freqs_2d=2))
    report = {"psnr_vs_teacher": 21.5, "psnr_vs_teacher_min": 19.25, "n_views": 8, "n_holdout": 2, "steps": 30}
    teacher_ckpt = str(tmp_path / "model.npz")
    sidecar = pd.turbo_sidecar_path(teacher_ckpt)
    assert sidecar == jd.turbo_sidecar_path(teacher_ckpt) == str(tmp_path / "model.turbo.npz")
    pd.save_turbo_checkpoint(sidecar, params_from_numpy(student), cfg, n_importance_serving=12,
                             proposal_subsample_serving=2, report=report, teacher=teacher_ckpt, step=30)
    jcfg = jd.student_config(H, W, near=NEAR, far=FAR, depth=2, net_width=32, num_freqs_3d=5, n_samples=8)
    jcfg = dataclasses.replace(jcfg, rendering=dataclasses.replace(jcfg.rendering, num_freqs_2d=2))
    ref_path = str(tmp_path / "ref" / "model.turbo.npz")
    os.makedirs(os.path.dirname(ref_path))
    jd.save_turbo_checkpoint(ref_path, student, jcfg, n_importance_serving=12, proposal_subsample_serving=2,
                             report=report, teacher=teacher_ckpt, step=30)
    meta = jd.read_turbo_metadata(sidecar)
    assert meta == jd.read_turbo_metadata(ref_path)
    assert meta["distill_report"]["measured_at"] == {"n_importance": 12, "proposal_subsample": 2}
    assert pd.read_turbo_metadata(sidecar) == meta
    jparams, jmeta = jd.load_turbo_checkpoint(sidecar)
    assert meta["step"] == 30 and jmeta == {k: v for k, v in meta.items() if k != "step"}
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(student)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    render_cfg = dict(experiment=dict(image_width=W, image_height=H), rendering=dict(depth_range=(NEAR, FAR)))
    pose = _poses(1, seed=2)[0]
    jr = JRenderer("tokyo", teacher_ckpt, precision="parity", use_pallas=False, preset="turbo",
                   config=JFramework(experiment=JExperiment(**render_cfg["experiment"]),
                                     rendering=JRendering(**render_cfg["rendering"])))
    jr.initialize_models()
    r = NeRFRenderer("tokyo", teacher_ckpt, precision="parity", preset="turbo", device="cpu",
                     config=FrameworkConfig(experiment=ExperimentConfig(**render_cfg["experiment"]),
                                            rendering=RenderingConfig(**render_cfg["rendering"])))
    r.initialize_models()
    assert r.settings.n_importance == 12 and r.settings.proposal_subsample == 2 and r.settings.n_samples == 8
    want = np.asarray(jr.render_pose(pose))
    got = r.render_pose(pose).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_distill_student_runs_and_reports_jax_keys(tmp_path):
    """A short run of a small student on precomputed teacher views: JAX's
    report keys, a finite PSNR, a proposal + fine tree; too few poses and a
    wrong teacher_rgb shape raise as JAX's do."""
    teacher = params_from_numpy(_teacher())
    settings = RenderSettings(**SETTINGS)
    poses = _poses(5, seed=3)
    rgb = pd.render_teacher_views(teacher, NerfMLPSpec(**SMALL), settings, poses, H, W, near=NEAR, far=FAR,
                                  device="cpu")
    kw = dict(height=H, width=W, near=NEAR, far=FAR, depth=2, net_width=32, num_freqs_3d=5, n_holdout=2,
              log_every=0, device="cpu")
    params, cfg, report = pd.distill_student(teacher, NerfMLPSpec(**SMALL), settings, poses, steps=30,
                                             teacher_rgb=rgb, save_dir=str(tmp_path / "run"), **kw)
    assert sorted(params) == ["fine", "proposal"]
    assert sorted(report) == ["n_holdout", "n_views", "psnr_vs_teacher", "psnr_vs_teacher_min", "steps"]
    assert np.isfinite(report["psnr_vs_teacher"]) and report["psnr_vs_teacher_min"] <= report["psnr_vs_teacher"]
    assert (report["n_views"], report["n_holdout"], report["steps"]) == (5, 2, 30)
    assert (cfg.model.net_depth_fine, cfg.model.net_width_fine, cfg.rendering.num_freqs_3d) == (2, 32, 5)
    assert (cfg.rendering.n_samples, cfg.rendering.n_importance) == (8, 8)
    with pytest.raises(ValueError, match="need at least 4 poses"):
        pd.distill_student(teacher, NerfMLPSpec(**SMALL), settings, poses[:3], steps=1, teacher_rgb=rgb[:3],
                           save_dir=str(tmp_path / "few"), **kw)
    with pytest.raises(ValueError, match="teacher_rgb shape"):
        pd.distill_student(teacher, NerfMLPSpec(**SMALL), settings, poses, steps=1, teacher_rgb=rgb[:1],
                           save_dir=str(tmp_path / "shape"), **kw)


def test_defaults_match_jax():
    assert pd.DEFAULT_STUDENT == jd.DEFAULT_STUDENT == {"depth": 6, "width": 192, "num_freqs_3d": 10}
    assert pd.SPEED_STUDENT == jd.SPEED_STUDENT == {"depth": 4, "width": 128, "num_freqs_3d": 8}
    assert pd.DEFAULT_DISTILL_STEPS == jd.DEFAULT_DISTILL_STEPS == 50_000
    ours, theirs = inspect.signature(pd.distill_student), inspect.signature(jd.distill_student)
    for name in ("steps", "depth", "net_width", "num_freqs_3d", "n_holdout", "seed", "log_every", "name",
                 "teacher_rgb", "n_samples", "n_importance_train"):
        assert ours.parameters[name].default == theirs.parameters[name].default, name
    for fn in ("save_turbo_checkpoint", "student_config", "office_distill_poses"):
        a, b = inspect.signature(getattr(pd, fn)), inspect.signature(getattr(jd, fn))
        assert {k: v.default for k, v in a.parameters.items()} == {k: v.default for k, v in b.parameters.items()}


def test_cli_parser_defaults_match_jax():
    from nerf_workspaces_explorer_tpu.cli.distill import build_parser as jparser
    from nerf_workspaces_explorer_tpu_torch.cli.distill import build_parser

    ours, theirs = vars(build_parser().parse_args([])), vars(jparser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    args = ["--office", "geneve", "--steps", "7", "--depth", "4", "--width", "128", "--freqs", "8", "--grid", "3",
            "--yaw-step", "90", "--view-scale", "2", "--n-importance-serving", "32", "--prop-subsample-serving",
            "2", "--n-samples", "16", "--out", "x.npz"]
    ours = vars(build_parser().parse_args(args))
    ours.pop("device")
    assert ours == vars(jparser().parse_args(args))


def test_cli_writes_a_sidecar_both_packages_load(tmp_path):
    """`cli.distill --device cpu` on the in-repo 8x256 teacher, cut to a few
    views of 8x6 and a 2x32 student: a sidecar that both packages load; without
    --device on a machine without CUDA it raises."""
    import shutil

    from nerf_workspaces_explorer_tpu_torch.cli.distill import main

    teacher = str(tmp_path / "teacher.npz")
    shutil.copy(HIER, teacher)
    args = ["--office", "tokyo", "--ckpt", teacher, "--steps", "20", "--grid", "2", "--yaw-step", "360",
            "--view-scale", "40", "--depth", "2", "--width", "32", "--freqs", "5", "--n-samples", "8"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    out = main(args + ["--device", "cpu"])
    assert out == str(tmp_path / "teacher.turbo.npz") and os.path.exists(out)
    params, meta = pd.load_turbo_checkpoint(out)
    jparams, jmeta = jd.load_turbo_checkpoint(out)
    assert meta == jmeta and meta["teacher"] == "teacher.npz"
    assert meta["student"] == {"depth": 2, "width": 32, "num_freqs_3d": 5, "num_freqs_2d": 4, "n_samples": 8,
                               "n_importance": 48, "proposal_num_freqs": 6, "proposal_subsample": 4}
    assert meta["distill_report"]["steps"] == 20 and meta["distill_report"]["n_views"] == 4
    assert sorted(params) == sorted(jparams) == ["fine", "proposal"]
    spec, _ = jd.student_spec_from_meta(jmeta)
    assert (spec.depth, spec.width, spec.input_ch) == (2, 32, 33)
