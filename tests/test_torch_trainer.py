"""The port's synthetic data, Trainer, train CLI and checkpoints, on the CPU,
against the JAX package where both compute the same thing."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.data import synthetic as jsynthetic
from nerf_workspaces_explorer_tpu.infer import checkpoint as jckpt
from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.train import init_train_state as jinit_train_state
from nerf_workspaces_explorer_tpu.train import make_optimizer as jmake_optimizer
from nerf_workspaces_explorer_tpu_torch.core.config import (
    FrameworkConfig,
    LoggingConfig,
    ModelConfig,
    RenderingConfig,
    TrainingConfig,
)
from nerf_workspaces_explorer_tpu_torch.data import synthetic
from nerf_workspaces_explorer_tpu_torch.data.replica import split_ids
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_training_checkpoint
from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

# 4x64 nets, F = 6/2, 256 rays of 16 + 16 samples; a rate that shows the
# loss falling within 40 steps.
TINY_YAML = """
training: {learning_rate: 0.005}
model: {net_depth: 4, net_width: 64, chunk: 4096}
rendering: {n_rays: 256, n_samples: 16, n_importance: 16, num_freqs_3d: 6, num_freqs_2d: 2,
            raw_noise_std: 1.0, depth_range: [0.1, 6.0]}
logging: {step_log_print: 1, step_log_tensorboard: 20, step_save_ckpt: 0,
          step_render_test: 20, step_render_train: 0}
"""


def tiny_config(**logging) -> FrameworkConfig:
    log = dict(step_log_print=0, step_log_tensorboard=20, step_save_ckpt=0,
               step_render_test=0, step_render_train=0)
    log.update(logging)
    return FrameworkConfig(
        training=TrainingConfig(learning_rate=5e-3),
        model=ModelConfig(net_depth=4, net_width=64, chunk=4096),
        rendering=RenderingConfig(n_rays=256, n_samples=16, n_importance=16, num_freqs_3d=6,
                                  num_freqs_2d=2, raw_noise_std=1.0, depth_range=(0.1, 6.0)),
        logging=LoggingConfig(**log),
    )


@pytest.fixture(scope="module")
def orbit():
    return synthetic.make_synthetic_scene(n_train=2, n_test=1, height=12, width=16)


def test_orbit_ground_truth_matches_jax(orbit):
    train, test, scene = orbit
    jtrain, jtest, jscene = jsynthetic.make_synthetic_scene(n_train=2, n_test=1, height=12, width=16)
    for a, b in zip(scene, jscene):
        np.testing.assert_array_equal(a, np.asarray(b))
    for mine, ref in ((train, jtrain), (test, jtest)):
        np.testing.assert_array_equal(mine.camera_pose, ref.camera_pose)
        np.testing.assert_allclose(mine.rgb, ref.rgb, atol=1e-5)
        np.testing.assert_allclose(mine.depth, ref.depth, atol=1e-4)


def test_room_splits_match_jax_and_cache_the_same(tmp_path):
    kw = dict(n_frames=10, stride=5, height=6, width=8, gt_samples=64)
    train, test, scene = synthetic.make_room_scene_splits(**kw)
    jtrain, jtest, jscene = jsynthetic.make_room_scene_splits(**kw)
    for a, b in zip(scene, jscene):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    for mine, ref in ((train, jtrain), (test, jtest)):
        np.testing.assert_array_equal(mine.camera_pose, ref.camera_pose)
        np.testing.assert_allclose(mine.rgb, ref.rgb, atol=1e-5)
        np.testing.assert_allclose(mine.depth, ref.depth, atol=1e-4)
    # With a cache: the JAX package's file name, uint8 / float16 contents.
    cached, _, _ = synthetic.make_room_scene_splits(**kw, cache_dir=str(tmp_path / "mine"))
    jcached, _, _ = jsynthetic.make_room_scene_splits(**kw, cache_dir=str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "mine") == os.listdir(tmp_path / "jax")
    np.testing.assert_array_equal(np.round(cached.rgb * 255), np.round(jcached.rgb * 255))
    assert np.array_equal(cached.rgb * 255.0, np.round(cached.rgb * 255.0))


def test_split_rule():
    assert split_ids(12) == ([0, 5, 10], [2, 7, 12])


def _trainer(tmp_path, data, **kwargs):
    train, test, _ = data
    cfg = kwargs.pop("config", tiny_config())
    return Trainer("office_tokyo", cfg, train_data=train, test_data=test,
                   save_dir=str(tmp_path / "run"), enable_tensorboard=False, device="cpu", **kwargs)


def test_trainer_lowers_loss_and_renders(tmp_path, orbit):
    trainer = _trainer(tmp_path, orbit)
    assert trainer.field_impl == "plain"  # "auto" on the CPU
    trainer.setup()
    losses = [float(trainer.step(i)["total_loss"]) for i in range(40)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert trainer.state.step == 40
    psnr = trainer.render_test_images(global_step=40)
    assert np.isfinite(psnr)
    assert os.path.isdir(os.path.join(trainer.save_dir, "test_render", "step_000040"))


def test_resume_restores_step_moments_and_trajectory(tmp_path, orbit):
    """A checkpoint restores params, Adam moments and the step count, and
    the resumed Trainer takes the same next step as the one that went on."""
    a = _trainer(tmp_path / "a", orbit)
    a.setup()
    for i in range(3):
        a.step(i)
    path = a.save_models_checkpoint(2)
    moments = [{k: v.clone() for k, v in a.state.optimizer.state[p].items()} for p in tree_leaves(a.params)]
    loss_a = float(a.step(3)["total_loss"])

    b = _trainer(tmp_path / "b", orbit)
    b.setup()
    assert b.resume_from_checkpoint(path) == 3
    for p, m in zip(tree_leaves(b.params), moments):
        st = b.state.optimizer.state[p]
        assert torch.equal(st["exp_avg"], m["exp_avg"]) and torch.equal(st["exp_avg_sq"], m["exp_avg_sq"])
        assert float(st["step"]) == 3
    loss_b = float(b.step(3)["total_loss"])
    assert loss_b == loss_a
    for pa, pb in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(pa, pb)


def test_checkpoints_cross_load(tmp_path, orbit):
    """The JAX package reads the port's `.npz` (params, and the Adam state
    into optax's layout); the port reads the JAX package's."""
    trainer = _trainer(tmp_path, orbit)
    trainer.setup()
    trainer.step(0)
    path = trainer.save_models_checkpoint(0)
    jspec = JSpec(depth=4, width=64, input_ch=39, input_ch_views=15)
    template = jinit_train_state(jax.random.PRNGKey(0), jspec, jmake_optimizer(5e-3))
    params, step, opt_state, meta = jckpt.load_checkpoint(path, opt_state_template=template.opt_state)
    assert step == 1 and meta["office"] == "office_tokyo"
    for a, b in zip(tree_leaves(trainer.params), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    mu = opt_state[0].mu
    for p, m in zip(tree_leaves(trainer.params), jax.tree_util.tree_leaves(mu)):
        np.testing.assert_array_equal(trainer.state.optimizer.state[p]["exp_avg"].numpy(), np.asarray(m))

    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, template.params, step=7, opt_state=template.opt_state)
    mine, mstep, opt_leaves, _ = load_training_checkpoint(jpath)
    assert mstep == 7 and len(opt_leaves) == len(jax.tree_util.tree_leaves(template.opt_state))
    for a, b in zip(tree_leaves(mine), jax.tree_util.tree_leaves(template.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = _trainer(tmp_path / "fresh", orbit)
    fresh.setup()
    assert fresh.resume_from_checkpoint(jpath) == 7
    for a, b in zip(tree_leaves(fresh.params), jax.tree_util.tree_leaves(template.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_train_cli_on_cpu_lowers_loss(tmp_path, capsys):
    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    main(["--synthetic", "--synthetic-size", "16", "--synthetic-views", "2", "1",
          "--iterations", "40", "--device", "cpu", "--config", str(cfg),
          "--save-dir", str(tmp_path / "run"), "--save-final"])
    out = capsys.readouterr().out
    losses = [float(line.split("Loss: ")[1].split(",")[0])
              for line in out.splitlines() if line.startswith("[TRAIN]")]
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert "Finished step: 40/40" in out
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "000040.npz")
    assert os.path.isdir(tmp_path / "run" / "test_render" / "step_000020")


@pytest.mark.parametrize("flag", [["--mesh", "3", "--synthetic-size", "16"]], ids=["mesh"])
def test_unported_cli_options_raise(flag):
    """`--mesh` was the CLI's last unported option; ported, it raises where
    the mesh cannot take the batch: the config's 1024 rays do not split
    over 3 shards (JAX step.py:239-241). The mesh itself is tested in
    tests/test_torch_parallel.py."""
    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        main(["--synthetic"] + flag + ["--device", "cpu"])


def _cli(tmp_path, *flags, iterations=3):
    """The train CLI on the CPU at the tiny config; its [TRAIN] losses."""
    import contextlib
    import io

    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    tmp_path.mkdir(parents=True, exist_ok=True)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--synthetic", "--synthetic-size", "16", "--synthetic-views", "2", "1", "--iterations",
              str(iterations), "--device", "cpu", "--config", str(cfg), "--save-dir", str(tmp_path / "run"),
              *flags])
    text = out.getvalue()
    return text, [float(x.split("Loss: ")[1].split(",")[0]) for x in text.splitlines() if x.startswith("[TRAIN]")]


@pytest.mark.parametrize("flags", [["--proposal"], ["--fast-preset"], ["--proposal", "--fast-preset"]],
                         ids=["proposal", "fast-preset", "proposal-fast-preset"])
def test_train_cli_proposal_and_fast_preset_lower_the_loss(tmp_path, flags):
    """--proposal trains the 2x64 proposal net in the coarse net's place (the
    interlevel loss as the coarse term, PSNR_coarse 0), --fast-preset the
    fine net on importance-only placement; either way the loss falls over
    40 steps and the final checkpoint holds the nets trained."""
    out, losses = _cli(tmp_path, *flags, "--save-final", iterations=40)
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    coarse_psnr = [x.split("PSNR_coarse: ")[1].split(",")[0] for x in out.splitlines() if x.startswith("[TRAIN]")]
    assert (set(coarse_psnr) == {"0.000"}) == ("--proposal" in flags)
    params, step, _, _ = load_training_checkpoint(str(tmp_path / "run" / "checkpoints" / "000040.npz"))
    assert step == 40 and sorted(params) == (["fine", "proposal"] if "--proposal" in flags else ["coarse", "fine"])


def test_train_cli_profile_writes_a_trace(tmp_path):
    """--profile DIR: the first steps (all 3 here) under torch.profiler, a
    Chrome trace in DIR/trace.json holding the training step's calls."""
    import json

    out, losses = _cli(tmp_path, "--profile", str(tmp_path / "prof"))
    assert len(losses) == 3 and "Profiled steps 1..3" in out
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in n or "matmul" in n for n in names)


def test_train_cli_export_final_writes_both_files(tmp_path, monkeypatch):
    """--export-final: final_models/<office>/model.npz (params and step) and
    the reference-format model.ckpt, relative to the working directory,
    holding the trained parameters; refused with --proposal before step 0."""
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_torch_checkpoint

    monkeypatch.chdir(tmp_path)
    _cli(tmp_path, "--export-final", "--save-final")
    final = tmp_path / "final_models" / "office_tokyo"
    params, step, _, meta = load_training_checkpoint(str(final / "model.npz"))
    assert step == 3 and meta["office"] == "office_tokyo"
    coarse, fine, ckpt_step = load_torch_checkpoint(str(final / "model.ckpt"))
    assert ckpt_step == 3
    saved, _, _, _ = load_training_checkpoint(str(tmp_path / "run" / "checkpoints" / "000003.npz"))
    for a, b, c in zip(tree_leaves({"coarse": coarse, "fine": fine}), tree_leaves(params), tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="no slot for --proposal"):
        _cli(tmp_path / "p", "--export-final", "--proposal")
    assert not (tmp_path / "p" / "run").exists()


def test_train_cli_nan_debug_turns_on_anomaly_detection(tmp_path):
    """--nan-debug: autograd's anomaly detection is on for the run."""
    assert not torch.is_anomaly_enabled()
    try:
        _, losses = _cli(tmp_path, "--nan-debug", iterations=1)
        assert torch.is_anomaly_enabled() and len(losses) == 1
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_resize_matches_jax_image_resize(orbit):
    """The eval ground truth at test_viz_factor 2 (and a non-integer
    factor): train/loop.py::resize_images against jax.image.resize
    bilinear (antialiased when downsampling) within 1e-5."""
    from nerf_workspaces_explorer_tpu_torch.train.loop import resize_images

    rgb = orbit[0].rgb
    for h, w in ((6, 8), (5, 7), (12, 16)):
        ref = np.asarray(jax.image.resize(jnp.asarray(rgb), (rgb.shape[0], h, w, 3), method="bilinear"))
        np.testing.assert_allclose(resize_images(rgb, h, w), ref, atol=1e-5)


def test_trainer_renders_eval_views_at_test_viz_factor(tmp_path, orbit):
    """rendering.test_viz_factor = 2: eval views render at half the
    resolution, scored against the downscaled ground truth (JAX
    train/loop.py:193-236, :306-307)."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.train.loop import resize_images

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, test_viz_factor=2))
    t = _trainer(tmp_path, orbit, config=cfg)
    t.setup()
    t.step(0)
    assert tuple(t.rays_test.origins.shape[:2]) == (1, 6 * 8) and tuple(t.rays_train.origins.shape[:2]) == (2, 12 * 16)
    images = t._render_image_set(t.rays_test, None)
    assert images.shape == (1, 6, 8, 3) and np.isfinite(images).all()
    gt = resize_images(orbit[1].rgb, 6, 8)
    want = float(-10.0 * np.log10(np.mean((images - gt) ** 2)))
    assert t.render_test_images(1) == pytest.approx(want, rel=1e-6)


def _proposal_trainer(tmp_path, data, **kwargs):
    return _trainer(tmp_path, data, use_proposal=True, **kwargs)


def test_proposal_trainer_resumes_and_cross_loads(tmp_path, orbit):
    """Trainer(use_proposal=True): the state holds {"proposal", "fine"}; a
    resumed Trainer takes the same next step (params, Adam moments, step);
    the JAX package loads the checkpoint (params and Adam state into a
    proposal TrainState's template) and the port's NeRFRenderer serves it
    at the fast preset; a stock Trainer refuses it."""
    from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    a = _proposal_trainer(tmp_path / "a", orbit)
    a.setup()
    assert sorted(a.params) == ["fine", "proposal"] and a.params["proposal"]["pts"][0]["w"].shape == (39, 64)
    for i in range(3):
        a.step(i)
    path = a.save_models_checkpoint(2)
    loss_a = float(a.step(3)["total_loss"])
    b = _proposal_trainer(tmp_path / "b", orbit)
    b.setup()
    assert b.resume_from_checkpoint(path) == 3
    assert float(b.step(3)["total_loss"]) == loss_a
    _assert_same_state(a, b)

    jspec = JSpec(depth=4, width=64, input_ch=39, input_ch_views=15)
    template = jinit_train_state(jax.random.PRNGKey(0), jspec, jmake_optimizer(5e-3),
                                 proposal_spec=jproposal_spec(6))
    params, step, opt_state, _ = jckpt.load_checkpoint(path, opt_state_template=template.opt_state)
    assert step == 3 and sorted(params) == ["fine", "proposal"]
    b2 = _proposal_trainer(tmp_path / "b2", orbit)
    b2.setup()
    b2.resume_from_checkpoint(path)
    for x, y in zip(tree_leaves(b2.params), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(y))
    for p, m in zip(tree_leaves(b2.params), jax.tree_util.tree_leaves(opt_state[0].mu)):
        np.testing.assert_array_equal(b2.state.optimizer.state[p]["exp_avg"].numpy(), np.asarray(m))

    cfg = tiny_config()
    r = NeRFRenderer("tokyo", path, config=_sized(cfg, 16, 12), precision="fast",
                     preset="fast", use_proposal=True, device="cpu")
    r.initialize_models()
    frame = r.render_pose_uint8(orbit[1].camera_pose[0])
    assert tuple(frame.shape) == (12, 16, 3) and frame.dtype == torch.uint8
    with pytest.raises(ValueError, match="needs use_proposal=True"):
        _trainer(tmp_path / "c", orbit).resume_from_checkpoint(path)


def _sized(cfg, width, height):
    import dataclasses

    return dataclasses.replace(cfg, experiment=dataclasses.replace(cfg.experiment, image_width=width,
                                                                   image_height=height))


def test_proposal_step_many_takes_the_single_steps(tmp_path, orbit):
    """step_many (K = 3, eager on the CPU) with a proposal net on the fast
    preset's placement: the single steps' losses, params and moments."""
    a = _proposal_trainer(tmp_path / "a", orbit, merge_coarse=False)
    a.setup()
    losses_a = [float(a.step(i)["total_loss"]) for i in range(6)]
    b = _proposal_trainer(tmp_path / "b", orbit, merge_coarse=False, steps_per_call=3)
    b.setup()
    losses_b = b.step_many(0)["total_loss_steps"].tolist() + b.step_many(3)["total_loss_steps"].tolist()
    assert losses_b == losses_a
    _assert_same_state(a, b)


def _params_moments(trainer):
    opt = trainer.state.optimizer
    leaves = tree_leaves(trainer.params)
    return ([p.detach().clone() for p in leaves],
            [(opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone()) for p in leaves])


def _assert_same_state(a, b):
    (pa, ma), (pb, mb) = _params_moments(a), _params_moments(b)
    assert a.state.step == b.state.step
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)
    for (m1, v1), (m2, v2) in zip(ma, mb):
        assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_step_many_takes_the_single_steps(tmp_path, orbit):
    """Trainer(steps_per_call=4).step_many on the CPU (K eager steps): the
    losses, parameters and Adam moments of single step() calls, bit for
    bit, with single steps on either side."""
    a = _trainer(tmp_path / "a", orbit)
    a.setup()
    losses_a = [float(a.step(i)["total_loss"]) for i in range(10)]
    b = _trainer(tmp_path / "b", orbit, steps_per_call=4)
    assert b.steps_per_call == 4
    b.setup()
    m = b.step_many(0)
    assert tuple(m["total_loss_steps"].shape) == (4,)
    assert float(m["total_loss"]) == float(m["total_loss_steps"][-1])
    losses_b = m["total_loss_steps"].tolist() + [float(b.step(4)["total_loss"])]
    losses_b += b.step_many(5)["total_loss_steps"].tolist() + [float(b.step(9)["total_loss"])]
    assert losses_b == losses_a
    _assert_same_state(a, b)


def test_step_and_step_many_go_through_the_loop_apply_step(tmp_path, orbit, monkeypatch):
    """step() and step_many() (K = 2, CPU) both take their steps through
    `train.loop.apply_step`, the name a patch of the step body replaces."""
    import nerf_workspaces_explorer_tpu_torch.train.loop as loop

    calls = []
    real = loop.apply_step
    monkeypatch.setattr(loop, "apply_step", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    trainer = _trainer(tmp_path, orbit, steps_per_call=2)
    trainer.setup()
    m = trainer.step(0)
    assert len(calls) == 1 and "total_loss_steps" not in m
    m = trainer.step_many(1)
    assert len(calls) == 3 and tuple(m["total_loss_steps"].shape) == (2,)


@pytest.mark.parametrize("k", [4, 5])
def test_fit_with_steps_per_call_keeps_the_cadence(tmp_path, orbit, capsys, k):
    """fit() with K = 4 or 5 and a print every 5 steps: the prints at steps
    0, 5 and 10 as with K = 1, the stretches between them as K-step calls
    (at K = 5 each ending on the printed step, its print after the call),
    the same parameters and moments after 13 steps; a cadence under K
    warns."""
    cfg = tiny_config(step_log_print=5)
    a = _trainer(tmp_path / "a", orbit, config=cfg)
    a.setup()
    a.fit(13)
    out_a = capsys.readouterr().out
    b = _trainer(tmp_path / "b", orbit, config=cfg, steps_per_call=k)
    b.setup()
    calls = []
    step_many = b.step_many
    b.step_many = lambda i: calls.append(i) or step_many(i)
    b.fit(13)
    out_b = capsys.readouterr().out
    assert calls == [1, 6]
    train_lines = lambda out: [x for x in out.splitlines() if x.startswith("[TRAIN]")]  # noqa: E731
    assert train_lines(out_a) == train_lines(out_b)
    assert [x.split(" Loss")[0] for x in train_lines(out_b)] == [
        "[TRAIN] Iter: 0", "[TRAIN] Iter: 5", "[TRAIN] Iter: 10"]
    _assert_same_state(a, b)
    c = _trainer(tmp_path / "c", orbit, config=cfg, steps_per_call=8)
    c.setup()
    c.fit(2)
    assert "steps_per_call=8 is limited by the 5-step logging cadence" in capsys.readouterr().out


def test_train_cli_steps_per_call_on_cpu(tmp_path, capsys):
    """`--steps-per-call 4 --device cpu` trains: the print cadence raised to
    4, one steps/s line, the final checkpoint."""
    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    main(["--synthetic", "--synthetic-size", "16", "--synthetic-views", "2", "1",
          "--iterations", "12", "--device", "cpu", "--config", str(cfg), "--steps-per-call", "4",
          "--save-dir", str(tmp_path / "run"), "--save-final"])
    out = capsys.readouterr().out
    assert "console print cadence raised to every 4 steps" in out
    iters = [int(x.split("Iter: ")[1].split(" ")[0]) for x in out.splitlines() if x.startswith("[TRAIN]")]
    assert iters == [0, 4, 8]
    assert "Finished steps 1..12 in" in out and "4 steps/dispatch" in out
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "000012.npz")


def test_trainer_config_is_the_given_config_as_in_jax(tmp_path, orbit):
    """`Trainer.config` (JAX train/loop.py:176): the configuration the
    trainer was given, or the office's default one loaded for it; the same
    for both packages' trainers built from one YAML file."""
    from nerf_workspaces_explorer_tpu.core.config import load_config as jload_config
    from nerf_workspaces_explorer_tpu.train import Trainer as JTrainer
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config

    cfg = tiny_config()
    assert _trainer(tmp_path / "a", orbit, config=cfg).config is cfg
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    mine = load_config(str(tmp_path / "tiny.yaml"), office_name="office_tokyo")
    theirs = jload_config(str(tmp_path / "tiny.yaml"), office_name="office_tokyo")
    jtrain, jtest, _ = jsynthetic.make_synthetic_scene(n_train=2, n_test=1, height=12, width=16)
    jtr = JTrainer("office_tokyo", theirs, train_data=jtrain, test_data=jtest, save_dir=str(tmp_path / "j"),
                   enable_tensorboard=False)
    assert jtr.config is theirs
    tr = _trainer(tmp_path / "b", orbit, config=mine)
    assert tr.config is mine and tr.config.to_dict() == jtr.config.to_dict()
    default = Trainer("office_tokyo", train_data=orbit[0], test_data=orbit[1], save_dir=str(tmp_path / "c"),
                      enable_tensorboard=False, device="cpu")
    assert default.config.to_dict() == JTrainer("office_tokyo", train_data=jtrain, test_data=jtest,
                                                save_dir=str(tmp_path / "d"), enable_tensorboard=False
                                                ).config.to_dict()


def test_step_graph_needs_the_capturable_optimizer(tmp_path, orbit):
    import functools

    from nerf_workspaces_explorer_tpu_torch.train.step import StepGraph, apply_step

    t = _trainer(tmp_path, orbit)
    t.setup()
    with pytest.raises(ValueError, match="capturable optimizer"):
        StepGraph(2)(t.state, functools.partial(apply_step, t.state, t.rays_train, t._train_rgbs,
                                                settings=t._settings, spec=t._spec),
                     [t._draws(0), t._draws(1)], t._schedule)


def test_trainer_needs_a_device_or_cuda_and_data(tmp_path, orbit, monkeypatch):
    from nerf_workspaces_explorer_tpu_torch.data import replica

    train, test, _ = orbit
    monkeypatch.setattr(replica, "DATASETS_PATH", str(tmp_path / "no_dataset"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer("office_tokyo", tiny_config(), train_data=train, test_data=test,
                    save_dir=str(tmp_path / "r"), enable_tensorboard=False)
    with pytest.raises(FileNotFoundError, match="no Replica sequence for 'office_tokyo'"):
        Trainer("office_tokyo", tiny_config(), save_dir=str(tmp_path / "r2"),
                enable_tensorboard=False, device="cpu")
    with pytest.raises(ValueError, match="field_impl"):
        Trainer("office_tokyo", tiny_config(), train_data=train, test_data=test,
                save_dir=str(tmp_path / "r3"), enable_tensorboard=False, device="cpu",
                field_impl="pallas")


@pytest.mark.parametrize("key,name", [
    ("field_fwd_kernel(FieldNet, rk::StreamT<160>, float const*, float*, int)", "field_fwd_kernel"),
    ("void sum_rows_kernel(float const*, int, unsigned long, float*)", "sum_rows_kernel"),
    ("aten::copy_", "aten::copy_"),
    ("void rk::render_kernel<192, 10, 0, false>(rk::NetPtrs, rk::Quant, rk::Stream, float const*, int)",
     "render_kernel"),
    ("void (anonymous namespace)::importance_merge_kernel<8>(float const*, float const*, float*, int)",
     "importance_merge_kernel"),
])
def test_kernel_name(key, name):
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import kernel_name

    assert kernel_name(key) == name


def test_device_kernel_counts_counts_device_kernels_only():
    """Device kernels by name, their counts summed over keys; host events
    and device-side user annotations left out."""
    from types import SimpleNamespace

    from nerf_workspaces_explorer_tpu_torch.obs.profiler import device_kernel_counts

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        SimpleNamespace(key="field_fwd_kernel(FieldNet, float*)", count=6, device_type=cuda),
        SimpleNamespace(key="void field_fwd_kernel(FieldNet, int)", count=2, device_type=cuda),
        SimpleNamespace(key="field_dw_kernel(DwJobs, int)", count=3, device_type=cuda),
        SimpleNamespace(key="aten::copy_", count=9, device_type=cpu),
        SimpleNamespace(key="Optimizer.step#Adam.step", count=1, device_type=cuda, is_user_annotation=True),
    ]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert device_kernel_counts(prof) == {"field_fwd_kernel": 8, "field_dw_kernel": 3}
