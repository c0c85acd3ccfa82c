"""The port's serving quality gate (`scripts/validate_quality_torch.py`)
against the JAX package's (`scripts/validate_quality.py`) on the CPU: the
parser's defaults, the gate's failures and report rows for the same leg
numbers, one leg's evaluation on one set of weights, and a tiny end-to-end
run."""

import importlib.util
import itertools
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")


def _load(name, module_name):
    spec = importlib.util.spec_from_file_location(module_name, os.path.join(ROOT, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jvq():
    return _load("validate_quality.py", "_jax_validate_quality")


@pytest.fixture(scope="module")
def pvq():
    return _load("validate_quality_torch.py", "_torch_validate_quality")


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.help, a.type, a.nargs, a.choices)
        for a in parser._actions
        if a.dest != "help"
    }


def test_parser_equals_jax(jvq, pvq):
    """Every option of the JAX gate, with its default and help, and
    `--device` (default cuda) besides."""
    ours, theirs = _actions(pvq.build_parser()), _actions(jvq.build_parser())
    assert ours.pop("device")[1] == "cuda"
    assert ours == theirs
    got = vars(pvq.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == vars(jvq.build_parser().parse_args([]))


def test_turbo_defaults_are_the_ports_student(pvq):
    from nerf_workspaces_explorer_tpu_torch.train.distill import DEFAULT_DISTILL_STEPS, DEFAULT_STUDENT

    args = pvq.build_parser().parse_args([])
    assert (args.turbo_depth, args.turbo_width, args.turbo_freqs) == (
        DEFAULT_STUDENT["depth"], DEFAULT_STUDENT["width"], DEFAULT_STUDENT["num_freqs_3d"])
    assert args.turbo_steps == DEFAULT_DISTILL_STEPS
    # The JAX package's calibrated windows (tests/test_distill.py): the
    # passing room report's drop 0.0111 and worst view 0.7811 (teacher's
    # 0.7871) pass, the failing 4x128 recipe's 0.0545 / 0.7199 fail.
    assert 0.011 < args.max_turbo_ssim_drop < 0.055
    assert 0.7199 / 0.7871 < args.min_turbo_ssim_ratio < 0.7811 / 0.7871


def test_gate_without_cuda_raises(pvq, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pvq.main(["--steps", "0", "--out", str(tmp_path)])


# Leg numbers that pass every gate at the defaults with --proposal
# --fast-preset --turbo --prop-subsample 4; each case breaks one gate.
def _legs():
    fast = lambda p: {128: dict(psnr=p, ssim=0.9, psnr_sub=p - 0.1, ssim_sub=0.89),  # noqa: E731
                      96: dict(psnr=p - 0.4, ssim=0.88, psnr_sub=p - 0.5, ssim_sub=0.87)}
    hier = dict(psnr=27.5, psnr_min=25.1, ssim=0.91, ssim_min=0.85, fidelity=0.9995, fidelity_int8=0.998,
                fast=fast(27.3), trainer=None)
    prop = dict(psnr=27.2, psnr_min=24.9, ssim=0.905, ssim_min=0.84, fidelity=0.9993, fidelity_int8=0.997,
                fast=fast(27.0), trainer=None)
    turbo = dict(psnr=26.8, psnr_min=24.0, ssim=0.89, ssim_min=0.80, teacher_psnr=27.2, teacher_psnr_min=24.5,
                 teacher_ssim=0.905, teacher_ssim_min=0.82, psnr_vs_teacher=33.0, gate_tag="test views (3)",
                 psnr_sub=26.7, psnr_sub_min=23.9, ssim_sub=0.888)
    return hier, prop, turbo


def _set_fast(leg, **kw):
    leg["fast"][128].update(kw)


GATE_CASES = {
    "all_pass": lambda h, p, t: None,
    "psnr": lambda h, p, t: h.update(psnr=23.9),
    "fused": lambda h, p, t: h.update(fidelity=0.985),
    "int8": lambda h, p, t: h.update(fidelity_int8=0.95),
    "proposal_drop": lambda h, p, t: p.update(psnr=26.7),
    "proposal_fused": lambda h, p, t: p.update(fidelity=0.98),
    "proposal_int8": lambda h, p, t: p.update(fidelity_int8=0.97),
    "fast_drop": lambda h, p, t: _set_fast(p, psnr=26.6, psnr_sub=26.5),
    "subsample_drop": lambda h, p, t: _set_fast(p, psnr_sub=26.6),
    "turbo_drop": lambda h, p, t: t.update(psnr=26.1, psnr_sub=26.0),
    "turbo_over_teacher": lambda h, p, t: t.update(psnr=27.6, psnr_sub=27.5),
    "turbo_subsample_drop": lambda h, p, t: t.update(psnr_sub=26.4),
    "ssim_drop": lambda h, p, t: t.update(ssim=0.87),
    "worst_view_ssim": lambda h, p, t: t.update(ssim_min=0.75),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_failures_and_rows_equal_jax(case, jvq, pvq, tmp_path, monkeypatch, capsys):
    """The same leg numbers through JAX's `main` (its legs and scene
    functions replaced) and through the port's `gate_failures` and
    `write_report`: the failure strings and the report's rows are equal."""
    hier, prop, turbo = _legs()
    GATE_CASES[case](hier, prop, turbo)
    flags = ["--proposal", "--fast-preset", "--turbo", "--prop-subsample", "4"]

    scene = types.SimpleNamespace(rgb=np.zeros((3, 2, 2, 3)), depth=np.zeros((3, 2, 2)),
                                  camera_pose=np.zeros((3, 4, 4)))
    import nerf_workspaces_explorer_tpu.data as jdata

    monkeypatch.setattr(jdata, "make_synthetic_scene", lambda **kw: (scene, scene, None))
    monkeypatch.setattr(jvq, "run_leg", lambda name, *a: {"hier": hier, "prop": prop}[name])
    monkeypatch.setattr(jvq, "run_turbo_leg", lambda *a: turbo)
    jax_report = tmp_path / "jax.md"
    monkeypatch.setattr(sys, "argv", ["validate_quality.py", *flags, "--out", str(tmp_path / "out"),
                                      "--report", str(jax_report)])
    code = 0
    try:
        jvq.main()
    except SystemExit as e:
        code = e.code
    jax_out = capsys.readouterr().out

    args = pvq.build_parser().parse_args(flags)
    failures = pvq.gate_failures(args, hier, prop, turbo)
    port_out = capsys.readouterr().out
    port_report = tmp_path / "port.md"
    pvq.write_report(str(port_report), args, hier, prop, turbo, failures, 12, 3, "a card")

    assert (code == 1) == bool(failures) == (case != "all_pass")
    last = jax_out.strip().splitlines()[-1]
    assert last == ("QUALITY GATE FAILED: " + "; ".join(failures) if failures else "QUALITY GATE PASSED")
    if case != "all_pass":
        assert len(failures) == 1  # each case breaks only its own gate
    # The per-gate lines printed before the verdict.
    gate_lines = lambda out: [x for x in out.splitlines() if "gate" in x and not x.startswith(("report", "QUALITY"))]  # noqa: E731
    assert gate_lines(port_out) == gate_lines(jax_out)

    def rows(path):
        lines = path.read_text().splitlines()
        return [x for x in lines if x.startswith("|") or x.startswith("Turbo gates") or x.startswith("Result")]

    assert rows(port_report) == rows(jax_report)
    assert "a card" in port_report.read_text()


def _jax_trainer_with(params, monkeypatch):
    """Start JAX's Trainer from `params` (numpy) in place of its own init."""
    import jax.numpy as jnp
    from nerf_workspaces_explorer_tpu.train import loop as jloop

    setup = jloop.Trainer.setup

    def seeded_setup(self):
        setup(self)
        self._state = self._state._replace(params=jax.tree.map(jnp.asarray, params))

    monkeypatch.setattr(jloop.Trainer, "setup", seeded_setup)


def _recorder(module, name, store, monkeypatch, **fixed):
    """Wrap module.name to keep each call's output as a numpy array."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **fixed, **kw)
        rgb = out["rgb_fine"] if isinstance(out, dict) else out
        store.append(np.asarray(rgb.cpu() if isinstance(rgb, torch.Tensor) else rgb, dtype=np.float32))
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_leg_evaluation_matches_jax(jvq, pvq, tmp_path, monkeypatch):
    """JAX's `run_leg` at steps=0 (the Pallas kernels in interpret mode) and
    the port's (the kernels' plain versions on the CPU) from the same
    trained weights (`assets/bench/synth_hier.npz`) on a 12x16 orbit: the
    fp32 reference renders equal to 1e-5 (the ROADMAP table's fp32 bound),
    the bf16 fused renders to 5e-3 and the int8 renders to 5e-3 (the fused
    path's bound), and the leg's numbers to what those bounds allow."""
    from nerf_workspaces_explorer_tpu.core import config as jc
    from nerf_workspaces_explorer_tpu.data import SceneData as JScene
    from nerf_workspaces_explorer_tpu import render as jrender
    from nerf_workspaces_explorer_tpu.ops import pallas_render
    from nerf_workspaces_explorer_tpu_torch.core import config as pc
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render
    from nerf_workspaces_explorer_tpu_torch.render import pipeline

    h, w = 12, 16
    train, test, _ = make_synthetic_scene(n_train=12, n_test=3, height=h, width=w, device="cpu")
    params, _, _ = load_checkpoint(HIER)
    flags = ["--steps", "0", "--height", str(h), "--width", str(w), "--device", "cpu"]
    logging = dict(step_log_print=0, step_log_tensorboard=2**31 - 1, step_save_ckpt=0, step_render_test=0,
                   step_render_train=0)

    def cfg(c):
        return c.FrameworkConfig(experiment=c.ExperimentConfig(image_width=w, image_height=h),
                                 rendering=c.RenderingConfig(depth_range=(0.1, 6.0)),
                                 logging=c.LoggingConfig(**logging))

    jax_fused, jax_ref = [], []
    _recorder(pallas_render, "render_rays_fused", jax_fused, monkeypatch, interpret=True)
    _recorder(jrender, "render_rays_chunked", jax_ref, monkeypatch)
    _jax_trainer_with(params, monkeypatch)
    monkeypatch.setattr(jvq, "time", types.SimpleNamespace(time=itertools.count().__next__))  # 0 steps in 1 s
    jargs = jvq.build_parser().parse_args(flags[:-2] + ["--out", str(tmp_path / "jax")])
    os.makedirs(jargs.out)
    jsplit = lambda d: JScene(rgb=d.rgb, depth=d.depth, camera_pose=d.camera_pose)  # noqa: E731
    jleg = jvq.run_leg("hier", False, jsplit(train), jsplit(test), cfg(jc), jargs)

    port_fused, port_ref = [], []
    _recorder(fused_render, "render_rays_fused", port_fused, monkeypatch)
    _recorder(pipeline, "render_rays_chunked", port_ref, monkeypatch)
    pargs = pvq.build_parser().parse_args(flags + ["--out", str(tmp_path / "port")])
    os.makedirs(pargs.out)
    pleg = pvq.run_leg("hier", False, train, test, cfg(pc), pargs, params=params)

    # Three bf16 views, then the int8 render of the last view.
    assert len(jax_fused) == len(port_fused) == len(test) + 1
    got = lambda xs: [x.reshape(-1, 3) for x in xs]  # noqa: E731
    for a, b in zip(got(port_fused[:-1]), got(jax_fused[:-1])):
        assert np.abs(a - b).max() <= 5e-3
    assert np.abs(got(port_fused)[-1] - got(jax_fused)[-1]).max() <= 5e-3
    assert np.abs(got(port_ref)[0] - got(jax_ref)[0]).max() <= 1e-5
    # The trained fixture renders content: the fidelities below are of real images.
    assert jleg["psnr"] > 20.0 and port_fused[0].std() > 0.05
    # PSNR moves by at most 10 log10(1 + (2 sqrt(mse) d + d^2) / mse) for
    # per-pixel changes of at most d = 5e-3 (mse ~ 5e-3 here: ~0.6 dB);
    # the measured gap is far inside it.
    for key in ("psnr", "psnr_min"):
        mse = 10 ** (-jleg[key] / 10)
        bound = 10 * np.log10(1 + (2 * np.sqrt(mse) * 5e-3 + 25e-6) / mse)
        assert abs(pleg[key] - jleg[key]) <= bound, (key, pleg[key], jleg[key], bound)
    for key in ("ssim", "ssim_min", "fidelity", "fidelity_int8"):
        assert abs(pleg[key] - jleg[key]) <= 2e-3, (key, pleg[key], jleg[key])
    assert pleg["fidelity"] >= 0.99 and pleg["fidelity_int8"] >= 0.99
    assert os.path.exists(os.path.join(pargs.out, "render_hier.png"))
    assert os.path.exists(os.path.join(pargs.out, "ground_truth.png"))


def test_train_leg_prints_every_500th_step_and_covers_every_step(pvq, capsys):
    """One step a call at the progress prints, `step_many` stretches of K
    between them, every step taken once and in order."""
    calls = []

    class FakeTrainer:
        steps_per_call = pvq.STEPS_PER_CALL
        _device = torch.device("cpu")

        def step(self, i):
            calls.append((i, 1))
            return {"total_loss": torch.tensor(0.5), "psnr_fine": torch.tensor(20.0)}

        def step_many(self, i):
            calls.append((i, self.steps_per_call))

    pvq.train_leg(FakeTrainer(), "leg", 1203)
    taken = [i + j for i, k in calls for j in range(k)]
    assert taken == list(range(1203))
    singles = {i for i, k in calls if k == 1}
    assert {0, 500, 1000} <= singles and len(singles) < 40
    assert [x.split(":")[0] for x in capsys.readouterr().out.splitlines()] == [
        "[leg] step 0", "[leg] step 500", "[leg] step 1000"]


def test_gate_end_to_end_on_cpu(pvq, tmp_path, capsys):
    """`main` at steps 0 on a 12x16 orbit with the proposal leg, the fast
    preset and the strided placement: an untrained model misses the PSNR
    gate, so it exits 1 after writing its report and PNGs."""
    report = tmp_path / "gate.md"
    code = pvq.main(["--steps", "0", "--height", "12", "--width", "16", "--device", "cpu", "--proposal",
                     "--fast-preset", "--fast-n-importance", "32", "--prop-subsample", "4",
                     "--out", str(tmp_path / "out"), "--report", str(report)])
    out = capsys.readouterr().out
    assert code == 1
    assert out.strip().splitlines()[-1].startswith("QUALITY GATE FAILED: test PSNR")
    text = report.read_text()
    assert "**QUALITY GATE FAILED**" in text and "the CPU" in text
    assert "--proposal --fast-preset --prop-subsample 4 --height 12 --width 16" in text
    rows = [x for x in text.splitlines() if x.startswith("| hier") or x.startswith("| prop")]
    assert len(rows) == 6  # merged, fast at 32, fast at 32 strided; per leg
    for name in ("render_hier.png", "render_prop.png", "ground_truth.png"):
        assert os.path.exists(tmp_path / "out" / name)


def test_turbo_leg_on_cpu(pvq, tmp_path):
    """`run_turbo_leg` end to end on the CPU: a small teacher (2x32 nets, 8 +
    8 samples) distilled into a 2x32@4f student on the orbit's views, the
    held-out test views as the gate, exact and strided placement."""
    from nerf_workspaces_explorer_tpu_torch.core import config as pc
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    h, w = 12, 16
    train, test, _ = make_synthetic_scene(n_train=12, n_test=3, height=h, width=w, device="cpu")
    cfg = pc.FrameworkConfig(
        experiment=pc.ExperimentConfig(image_width=w, image_height=h),
        model=pc.ModelConfig(net_depth=2, net_width=32, net_depth_fine=2, net_width_fine=32),
        rendering=pc.RenderingConfig(depth_range=(0.1, 6.0), n_samples=8, n_importance=8, n_rays=64),
        logging=pc.LoggingConfig(step_log_print=0, step_log_tensorboard=2**31 - 1, step_save_ckpt=0,
                                 step_render_test=0, step_render_train=0))
    teacher = Trainer("teacher", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / "teacher"),
                      enable_tensorboard=False, use_proposal=True, device="cpu")
    teacher.setup()
    args = pvq.build_parser().parse_args([
        "--height", str(h), "--width", str(w), "--device", "cpu", "--turbo", "--turbo-steps", "2",
        "--turbo-depth", "2", "--turbo-width", "32", "--turbo-freqs", "4", "--turbo-n-samples", "8",
        "--turbo-n-importance", "8", "--prop-subsample", "4", "--out", str(tmp_path / "out")])
    out = pvq.run_turbo_leg({"trainer": teacher}, "prop", train, test, args, {"near": 0.1, "far": 6.0})
    assert out["gate_tag"] == "test views (3)"
    for key in ("psnr", "psnr_min", "ssim", "ssim_min", "teacher_psnr", "teacher_psnr_min", "teacher_ssim",
                "teacher_ssim_min", "psnr_vs_teacher", "psnr_sub", "psnr_sub_min", "ssim_sub"):
        assert np.isfinite(out[key]), key
    assert out["psnr_min"] <= out["psnr"] and out["teacher_psnr_min"] <= out["teacher_psnr"]
    failures = pvq.gate_failures(args, {"psnr": 30.0, "fidelity": 1.0, "fidelity_int8": 1.0}, None, out)
    assert all(f.startswith("turbo") for f in failures)
