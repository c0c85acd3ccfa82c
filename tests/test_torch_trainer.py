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


@pytest.mark.parametrize("flag", [["--proposal"], ["--fast-preset"], ["--mesh", "4"],
                                  ["--profile", "p"], ["--nan-debug"], ["--export-final"], []],
                         ids=["proposal", "fast-preset", "mesh", "profile", "nan-debug", "export-final",
                              "replica"])
def test_unported_cli_options_raise(flag):
    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    synthetic_flag = [] if not flag else ["--synthetic"]
    with pytest.raises(NotImplementedError, match="not ported"):
        main(synthetic_flag + flag + ["--device", "cpu"])


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


def test_fit_with_steps_per_call_keeps_the_cadence(tmp_path, orbit, capsys):
    """fit() with K = 4 and a print every 5 steps: the prints at steps 0, 5
    and 10 as with K = 1, the stretches between them as K-step calls, the
    same parameters and moments after 13 steps; a cadence under K warns."""
    cfg = tiny_config(step_log_print=5)
    a = _trainer(tmp_path / "a", orbit, config=cfg)
    a.setup()
    a.fit(13)
    out_a = capsys.readouterr().out
    b = _trainer(tmp_path / "b", orbit, config=cfg, steps_per_call=4)
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


def test_step_graph_needs_the_capturable_optimizer(tmp_path, orbit):
    from nerf_workspaces_explorer_tpu_torch.train.step import StepGraph

    t = _trainer(tmp_path, orbit)
    t.setup()
    with pytest.raises(ValueError, match="capturable optimizer"):
        StepGraph(2)(t.state, t.rays_train, t._train_rgbs, [t._draws(0), t._draws(1)], t._settings, t._spec,
                     t._schedule)


def test_trainer_needs_a_device_or_cuda_and_data(tmp_path, orbit):
    train, test, _ = orbit
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer("office_tokyo", tiny_config(), train_data=train, test_data=test,
                    save_dir=str(tmp_path / "r"), enable_tensorboard=False)
    with pytest.raises(NotImplementedError, match="Replica loader is not ported"):
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
