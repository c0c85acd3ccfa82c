"""The port's multi-device layer (`parallel/`, the data-parallel step,
`Trainer(mesh=)`, `--mesh`, the dry run) against the JAX package's on the
CPU: JAX shards over the 8 virtual CPU devices that tests/conftest.py
forces, the port over the mesh `data_mesh(devices=["cpu"] * 8)`, its
stand-in for them (eight shards on one device). The renders and steps get
the same parameters and, for the step, each device's own random draws
reproduced from JAX's keys (`_jax_shard_draws`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params as jinit_nerf_params
from nerf_workspaces_explorer_tpu.parallel import data_mesh as jdata_mesh
from nerf_workspaces_explorer_tpu.parallel import shard_render as jshard_render
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu.render import render_ray_bundle as jrender_ray_bundle
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, tree_leaves
from nerf_workspaces_explorer_tpu_torch.ops import fused_render
from nerf_workspaces_explorer_tpu_torch.parallel import DataMesh, data_mesh, device_count, shard_render
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderDraws, RenderSettings, render_ray_bundle
from nerf_workspaces_explorer_tpu_torch.train import step as tstep

torch.set_num_threads(2)

SPEC = dict(depth=4, width=64, input_ch=39, input_ch_views=15)
SETTINGS = dict(n_samples=8, n_importance=8, num_freqs_3d=6, num_freqs_2d=2)
N_DEV = 8
MESH = data_mesh(devices=["cpu"] * N_DEV)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rays(h, w, f, c_x, c_y, near, far):
    """The same flat bundle for both packages."""
    jrays = jcreate_rays(jnp.eye(4)[None], h, w, f, f, c_x, c_y, near, far).reshape(h * w)
    return jrays, RayBundle(*(_t(x) for x in jrays))


@pytest.fixture(scope="module")
def params():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jparams = {"coarse": jinit_nerf_params(k1, JSpec(**SPEC)), "fine": jinit_nerf_params(k2, JSpec(**SPEC))}
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def test_data_mesh_shapes():
    """JAX's test_data_mesh_shapes on the port's device lists: a mesh of the
    first n devices, one data axis, more than there are raises; without a
    device list the mesh is over the CUDA cards."""
    assert MESH.size == N_DEV and MESH.axis_names == ("data",)
    assert MESH.devices == (torch.device("cpu"),) * N_DEV and MESH.distinct_devices == (torch.device("cpu"),)
    small = data_mesh(4, devices=["cpu"] * N_DEV)
    assert isinstance(small, DataMesh) and small.size == 4
    with pytest.raises(ValueError, match="requested 100 devices, have 8"):
        data_mesh(100, devices=["cpu"] * N_DEV)
    assert device_count() == torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {device_count() + 1} devices"):
        data_mesh(device_count() + 1)
    assert data_mesh(devices=["cuda"]).devices == (torch.device("cuda", 0),)
    jmesh = jdata_mesh()
    assert jmesh.devices.size == N_DEV and jmesh.axis_names == MESH.axis_names


@pytest.mark.parametrize("shape", [(8, 16), (10, 10)], ids=["128-rays", "100-rays-padded"])
def test_shard_render_plain_matches_single_and_jax(params, shape):
    """The plain leg against `render_ray_bundle` on one device and against
    JAX's `shard_render` over 8 devices, atol 1e-5 (fp32); 100 rays over 8
    shards are edge-padded to 104 and the padding stripped."""
    jparams, mine = params
    h, w = shape
    jrays, rays = _rays(h, w, 8.0, (w - 1) / 2.0, (h - 1) / 2.0, 0.1, 6.0)
    out = shard_render(mine, rays, RenderSettings(**SETTINGS), MESH, spec=NerfMLPSpec(**SPEC), chunk=64)
    assert out["rgb_fine"].shape == (h * w, 3)
    single = render_ray_bundle(mine, rays, RenderSettings(**SETTINGS).for_eval(), spec=NerfMLPSpec(**SPEC))
    for k in ("rgb_fine", "depth_fine", "acc_fine", "disp_fine"):
        np.testing.assert_allclose(out[k].numpy(), single[k].detach().numpy(), atol=1e-5, err_msg=k)
    ref = jshard_render(jparams, jrays, JSettings(**SETTINGS), jdata_mesh(), spec=JSpec(**SPEC), chunk=64)
    np.testing.assert_allclose(out["rgb_fine"].numpy(), np.asarray(ref["rgb_fine"]), atol=1e-5)
    # Chunked shards (13 rays over 8-ray tiles) and full outputs.
    chunked = shard_render(mine, rays, RenderSettings(**SETTINGS), MESH, spec=NerfMLPSpec(**SPEC), chunk=8,
                           full_outputs=True)
    np.testing.assert_allclose(chunked["rgb_fine"].numpy(), single["rgb_fine"].detach().numpy(), atol=1e-5)
    assert chunked["weights_fine"].shape == (h * w, 16)


def test_shard_render_fused_leg_matches_jax_kernel(params):
    """The fused leg per shard (K1/K2/K3's plain versions on the CPU) against
    JAX's `shard_render(use_pallas=True)` in interpret mode, atol 5e-3 (the
    bf16 kernels' bound, tests/test_parallel.py:91-99), and against the
    port's unsharded fused path exactly."""
    jparams, mine = params
    jrays, rays = _rays(8, 16, 8.0, 7.5, 3.5, 0.5, 4.0)
    out = shard_render(mine, rays, RenderSettings(**SETTINGS), MESH, use_fused=True)
    ref = jshard_render(jparams, jrays, JSettings(**SETTINGS), jdata_mesh(), spec=JSpec(**SPEC), use_pallas=True,
                        interpret=True)
    assert out["rgb_fine"].shape == (128, 3)
    np.testing.assert_allclose(out["rgb_fine"].numpy(), np.asarray(ref["rgb_fine"]), atol=5e-3)
    jsingle = jrender_ray_bundle(jparams, jrays, JSettings(**SETTINGS).for_eval(), spec=JSpec(**SPEC))
    np.testing.assert_allclose(out["rgb_fine"].numpy(), np.asarray(jsingle["rgb_fine"]), atol=5e-3)
    kp = {k: fused_render.prepare_kernel_params(p, NerfMLPSpec(**SPEC)) for k, p in mine.items()}
    single = fused_render.render_rays_fused(kp, rays, RenderSettings(**SETTINGS), early_stop_eps=1e-3)
    np.testing.assert_array_equal(out["rgb_fine"].numpy(), single.numpy())
    # Prepared kernel parameters shard the same way.
    prepared = shard_render(kp, rays, RenderSettings(**SETTINGS), MESH, use_fused=True)
    np.testing.assert_array_equal(prepared["rgb_fine"].numpy(), single.numpy())


def test_shard_render_serving_config_int8_proposal(params):
    """tests/test_parallel.py:102-134 on the port: the proposal net's
    density pass and the int8 kernels per shard (quant threaded through
    `shard_render`), against the fp32 render: mean error < 4e-3, max <
    4e-2."""
    from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec
    from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_model_quant

    jparams, _ = params
    k1, _ = jax.random.split(jax.random.PRNGKey(5))
    jserve = {"proposal": jinit_nerf_params(k1, jproposal_spec(6)), "fine": jparams["fine"]}
    for p in jserve.values():
        p["alpha"]["b"] = p["alpha"]["b"] + 1.5
    serve = params_from_numpy(jax.tree.map(np.asarray, jserve))
    settings = RenderSettings(**SETTINGS)._replace(use_proposal=True, proposal_num_freqs=6)
    quant = calibrate_model_quant(serve, NerfMLPSpec(**SPEC), box=4.0)
    assert all(q.int8_heads for q in quant.values())
    _, rays = _rays(8, 16, 8.0, 7.5, 3.5, 0.5, 4.0)
    out = shard_render(serve, rays, settings, MESH, use_fused=True, quant=quant)
    assert out["rgb_fine"].shape == (128, 3)
    single = render_ray_bundle(serve, rays, settings.for_eval(), spec=NerfMLPSpec(**SPEC))
    err = np.abs(out["rgb_fine"].numpy() - single["rgb_fine"].detach().numpy())
    assert np.all(np.isfinite(err))
    assert err.mean() < 4e-3, err.mean()
    assert err.max() < 4e-2, err.max()


def test_stride_lattice_split_by_rows(params):
    """With `grid_hw`, a shard is a block of whole rows: where the rows
    divide by the mesh and the stride divides the blocks, the sharded
    lattice is the single-device one exactly; otherwise each shard places
    its rays exactly (JAX sharding.py:81-86)."""
    from nerf_workspaces_explorer_tpu_torch.models.mlp import init_nerf_params
    from nerf_workspaces_explorer_tpu_torch.ops.quantize import spec_from_net_params
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    _, mine = params
    gen = torch.Generator().manual_seed(1)
    turbo = {"proposal": init_nerf_params(gen, proposal_spec(6)), "fine": mine["fine"]}
    turbo["proposal"]["alpha"]["b"] = turbo["proposal"]["alpha"]["b"] + 1.5  # density that varies by ray
    settings = RenderSettings(**SETTINGS)._replace(use_proposal=True, merge_coarse=False, proposal_subsample=2)
    _, rays = _rays(32, 4, 2.0, 1.5, 15.5, 0.5, 4.0)
    kp = {k: fused_render.prepare_kernel_params(p, spec_from_net_params(p)) for k, p in turbo.items()}
    single = fused_render.render_rays_fused(kp, rays, settings, early_stop_eps=1e-3, grid_hw=(32, 4))
    exact = fused_render.render_rays_fused(kp, rays, settings, early_stop_eps=1e-3)
    assert not torch.equal(single, exact)  # the lattice changes the frame
    sharded = shard_render(kp, rays, settings, MESH, use_fused=True, grid_hw=(32, 4))["rgb_fine"]
    np.testing.assert_array_equal(sharded.numpy(), single.numpy())
    three = data_mesh(devices=["cpu"] * 3)  # 32 rows do not split over 3: exact placement per shard
    np.testing.assert_array_equal(shard_render(kp, rays, settings, three, use_fused=True, grid_hw=(32, 4))
                                  ["rgb_fine"].numpy(), exact.numpy())


def _jax_shard_draws(key, step, n_img, hw, per_dev, settings):
    """Each device's draws in JAX's data-parallel step (step.py:249-256):
    one image from img_key, pixels from fold_in(img_key, idx + 1), the
    render's four keys split from fold_in(render_base, idx)."""
    img_key, render_base = jax.random.split(jax.random.fold_in(key, step))
    img_idx = torch.tensor(int(jax.random.randint(img_key, (), 0, n_img)))
    s, i = settings.n_samples, settings.n_importance
    draws = []
    for idx in range(N_DEV):
        pix_idx = jax.random.randint(jax.random.fold_in(img_key, idx + 1), (per_dev,), 0, hw)
        k_perturb, k_noise_c, k_noise_f, k_imp = jax.random.split(jax.random.fold_in(render_base, idx), 4)
        render = RenderDraws(
            t_rand=_t(jax.random.uniform(k_perturb, (per_dev, s))),
            noise_coarse=_t(jax.random.normal(k_noise_c, (per_dev, s))),
            noise_fine=_t(jax.random.normal(k_noise_f, (per_dev, s + i))),
            u=_t(jax.random.uniform(k_imp, (per_dev, i))),
        )
        draws.append(tstep.StepDraws(img_idx, torch.from_numpy(np.array(pix_idx)).long(), render))
    return draws


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(scale=0.3, size=(3, 3))
    rays = jcreate_rays(jnp.asarray(poses), 8, 8, 4.0, 4.0, 3.5, 3.5, 0.5, 4.0)
    rgbs = rng.uniform(size=(3, 64, 3)).astype(np.float32)
    return rays, rgbs


def test_jax_mesh_gradient_is_the_shards_sum():
    """Why the port's step applies the shards' summed gradient: in JAX's
    `shard_map`, `jax.grad` of a replicated parameter already sums the
    devices' gradients, and `pmean` of that replicated value returns it.
    Eight devices, each loss the sum of its one x = 1: the mean of the
    local gradients would be 1, JAX's step gets 8."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def device_fn(p, x):
        return jax.lax.pmean(jax.grad(lambda q: jnp.sum(q * x))(p), "data")

    g = shard_map(device_fn, mesh=jdata_mesh(), in_specs=(P(), P("data")), out_specs=P())(
        jnp.float32(1.0), jnp.ones(N_DEV))
    assert float(g) == N_DEV


def test_data_parallel_step_matches_jax_mesh_step(scene):
    """Two data-parallel steps on the port's 8-shard mesh against JAX's
    `make_train_step(mesh=)` over 8 devices, from the same parameters and
    each device's reproduced draws: the new parameters within rel 1e-4 of
    each leaf's largest value, the scalar metrics (each the mean over
    shards, JAX's pmean) within rel 1e-5, `trans_fine` gathered to
    [n_rays, S + I] in shard order (JAX's P(axis) out-spec). The update
    applies the shards' summed gradient, as JAX's does (the test above);
    with their mean instead, Adam's eps weighs 8x more on the smallest
    gradients and the parameters differ by rel 2e-3 here. Gradients come
    from autograd.grad, so no leaf is left with a summed `.grad`."""
    from nerf_workspaces_explorer_tpu.train import init_train_state as jinit_train_state
    from nerf_workspaces_explorer_tpu.train import make_optimizer as jmake_optimizer
    from nerf_workspaces_explorer_tpu.train import make_train_step

    rays, rgbs = scene
    n_rays, jspec = 64, JSpec(**SPEC)
    jsettings = JSettings(**SETTINGS, raw_noise_std=1.0)
    opt = jmake_optimizer(5e-4)
    jstate = jinit_train_state(jax.random.PRNGKey(2), jspec, opt)
    params = jax.tree.map(np.asarray, jstate.params)
    key = jax.random.PRNGKey(3)
    jstep = make_train_step(jsettings, jspec, opt, n_rays, mesh=jdata_mesh(), donate=False)
    schedule = tstep.ExponentialDecay(5e-4)
    state = tstep.init_train_state(NerfMLPSpec(**SPEC), schedule, params=params)
    cpu = torch.device("cpu")
    rays_t, rgbs_t = {cpu: RayBundle(*(_t(f) for f in rays))}, {cpu: _t(rgbs)}
    settings = RenderSettings(**SETTINGS, raw_noise_std=1.0)
    for step in range(2):
        draws = _jax_shard_draws(key, step, 3, 64, n_rays // N_DEV, settings)
        jstate, jm = jstep(jstate, rays, jnp.asarray(rgbs), key)
        state, m = tstep.data_parallel_step(state, tstep.mesh_replicas(state, MESH), rays_t, rgbs_t, draws,
                                            settings, NerfMLPSpec(**SPEC), schedule, MESH)
        for k in ("rgb_loss_coarse", "rgb_loss_fine", "total_loss", "psnr_coarse", "psnr_fine"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
        assert m["trans_fine"].shape == (n_rays, 16) and jm["trans_fine"].shape == (n_rays, 16)
        np.testing.assert_allclose(m["trans_fine"].numpy(), np.asarray(jm["trans_fine"]), atol=1e-4)
    assert state.step == int(jstate.step) == 2
    for a, b in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jstate.params)):
        assert a.grad is None
        b = np.asarray(b)
        rel = float(np.abs(a.detach().numpy() - b).max() / np.abs(b).max())
        assert rel <= 1e-4, rel


def test_scanned_data_parallel_step_matches_jax_scanned_mesh_step(scene, tmp_path):
    """JAX's test_scanned_sharded_step_matches_single_steps against the
    port: `Trainer(mesh=, steps_per_call=3).step_many` on the 8-shard CPU
    mesh (three eager steps of `DataParallelBody`) against JAX's
    `make_train_step(mesh=, steps_per_call=3)` (`lax.scan` inside
    `shard_map`), from the same parameters, rays and colours and each
    step's per-device draws reproduced from JAX's keys. The tolerances of
    test_data_parallel_step_matches_jax_mesh_step: the parameters within
    rel 1e-4 of each leaf's largest value, the last step's scalar metrics
    and every step's total loss (JAX's single mesh steps) within rel 1e-5,
    `trans_fine` [n_rays, S + I] atol 1e-4 in shard order, at that test's
    rate (5e-4, JAX's default)."""
    import dataclasses

    from nerf_workspaces_explorer_tpu.train import init_train_state as jinit_train_state
    from nerf_workspaces_explorer_tpu.train import make_optimizer as jmake_optimizer
    from nerf_workspaces_explorer_tpu.train import make_train_step
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    rays, rgbs = scene
    n_rays, k, jspec = 64, 3, JSpec(**SPEC)
    jsettings = JSettings(**SETTINGS, raw_noise_std=1.0)
    opt = jmake_optimizer(5e-4)
    jstate = jinit_train_state(jax.random.PRNGKey(2), jspec, opt)
    params = jax.tree.map(np.asarray, jstate.params)
    key = jax.random.PRNGKey(3)
    jsingle = make_train_step(jsettings, jspec, opt, n_rays, mesh=jdata_mesh(), donate=False)
    jscanned = make_train_step(jsettings, jspec, opt, n_rays, mesh=jdata_mesh(), donate=False, steps_per_call=k)
    jlosses, js = [], jstate
    for _ in range(k):
        js, jm1 = jsingle(js, rays, jnp.asarray(rgbs), key)
        jlosses.append(float(jm1["total_loss"]))
    jstate, jm = jscanned(jstate, rays, jnp.asarray(rgbs), key)
    assert int(jstate.step) == k

    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config(str(tmp_path / "tiny.yaml"), office_name="office_tokyo")
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, learning_rate=5e-4))  # JAX's rate
    train, test, _ = make_synthetic_scene(n_train=3, n_test=1, height=8, width=8)
    tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / "run"),
                 enable_tensorboard=False, device="cpu", mesh=MESH, steps_per_call=k)
    tr.setup()
    with torch.no_grad():
        for dst, src in zip(tree_leaves(tr.params), jax.tree_util.tree_leaves(params)):
            dst.copy_(_t(src))
    tr.rays_train, tr._train_rgbs = RayBundle(*(_t(f) for f in rays)), _t(rgbs)
    settings = RenderSettings(**SETTINGS, raw_noise_std=1.0)
    tr._shard_draws = lambda step: _jax_shard_draws(key, step, 3, 64, n_rays // N_DEV, settings)
    m = tr.step_many(0)
    assert tr.state.step == k
    np.testing.assert_allclose(m["total_loss_steps"].numpy(), jlosses, rtol=1e-5)
    for name in ("rgb_loss_coarse", "rgb_loss_fine", "total_loss", "psnr_coarse", "psnr_fine"):
        assert float(m[name]) == pytest.approx(float(jm[name]), rel=1e-5), name
    assert m["trans_fine"].shape == (n_rays, 16) and jm["trans_fine"].shape == (n_rays, 16)
    np.testing.assert_allclose(m["trans_fine"].numpy(), np.asarray(jm["trans_fine"]), atol=1e-4)
    for a, b in zip(tree_leaves(tr.params), jax.tree_util.tree_leaves(jstate.params)):
        b = np.asarray(b)
        rel = float(np.abs(a.detach().numpy() - b).max() / np.abs(b).max())
        assert rel <= 1e-4, rel


def test_mesh_step_many_is_the_single_steps_bit_for_bit(tmp_path):
    """On the CPU `Trainer(mesh=, steps_per_call=3).step_many` runs the step
    body of `step` (`DataParallelBody`) three times: its losses, parameters
    and Adam moments equal three `step` calls' bit for bit."""
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config(str(tmp_path / "tiny.yaml"), office_name="office_tokyo")
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=6, width=8)
    trainers = []
    for name, k in (("single", 1), ("many", 3)):
        tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / name),
                     enable_tensorboard=False, device="cpu", mesh=MESH, steps_per_call=k)
        tr.setup()
        trainers.append(tr)
    single, many = trainers
    losses = [float(single.step(i)["total_loss"]) for i in range(3)]
    assert many.step_many(0)["total_loss_steps"].tolist() == losses
    assert many.state.step == single.state.step == 3
    for a, b in zip(tree_leaves(single.params), tree_leaves(many.params)):
        assert torch.equal(a, b)
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(single.state.optimizer.state[a][moment], many.state.optimizer.state[b][moment])


def test_data_parallel_step_refuses_indivisible_rays(scene):
    """n_rays=100 over 8 shards raises, in both packages (JAX
    step.py:239-241)."""
    from nerf_workspaces_explorer_tpu.train import make_optimizer as jmake_optimizer
    from nerf_workspaces_explorer_tpu.train import make_train_step

    with pytest.raises(ValueError, match="n_rays=100 not divisible by mesh size 8"):
        make_train_step(JSettings(**SETTINGS), JSpec(**SPEC), jmake_optimizer(5e-4), 100, mesh=jdata_mesh())
    gens = {torch.device("cpu"): torch.Generator()}
    with pytest.raises(ValueError, match="n_rays=100 not divisible by mesh size 8"):
        tstep.draw_shards(gens, list(range(N_DEV)), 0, 3, 64, 100, RenderSettings(**SETTINGS), MESH)


TINY_YAML = """
training: {learning_rate: 0.005}
model: {net_depth: 4, net_width: 64, chunk: 4096}
rendering: {n_rays: 64, n_samples: 8, n_importance: 8, num_freqs_3d: 6, num_freqs_2d: 2,
            raw_noise_std: 1.0, depth_range: [0.1, 6.0]}
logging: {step_log_print: 1, step_log_tensorboard: 20, step_save_ckpt: 0,
          step_render_test: 0, step_render_train: 0}
"""


def test_trainer_with_mesh_takes_finite_steps(tmp_path):
    """`Trainer(mesh=)`: five data-parallel steps, the last two as one call
    of steps_per_call=2; finite losses, the step count right, the draws of
    step 3 repeated by a second trainer, and a checkpoint in the usual
    format."""
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_training_checkpoint
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    cfg = load_config(str(tmp_path / "tiny.yaml"), office_name="office_tokyo")
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=6, width=8)

    def trainer(name, k=1):
        tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / name),
                     enable_tensorboard=False, device="cpu", mesh=MESH, steps_per_call=k)
        tr.setup()
        return tr

    tr = trainer("a", k=2)
    assert tr.mesh is MESH
    losses = [float(tr.step(i)["total_loss"]) for i in range(3)]
    m = tr.step_many(3)
    losses += m["total_loss_steps"].tolist()
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert tr.state.step == 5
    assert m["trans_fine"].shape == (64, 16)
    other = trainer("b")
    for i in range(3):
        other.step(i)
    assert float(other.step(3)["total_loss"]) == losses[3]
    params, step, opt_leaves, _ = load_training_checkpoint(tr.save_models_checkpoint(5))
    assert step == 5 and sorted(params) == ["coarse", "fine"] and opt_leaves
    with pytest.raises(ValueError, match="not the mesh's first device"):
        Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / "c"),
                enable_tensorboard=False, device="cuda", mesh=MESH)


def test_train_cli_mesh_on_cpu(tmp_path, capsys):
    """`--mesh 8 --device cpu`: eight shards of the CPU (`data_mesh(8,
    devices=[cpu] * 8)`) on a tiny synthetic run; every step's loss finite."""
    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    main(["--synthetic", "--synthetic-size", "16", "--synthetic-views", "2", "1", "--iterations", "4",
          "--device", "cpu", "--config", str(tmp_path / "tiny.yaml"), "--save-dir", str(tmp_path / "run"),
          "--mesh", "8"])
    out = capsys.readouterr().out
    losses = [float(line.split("Loss: ")[1].split(",")[0]) for line in out.splitlines() if line.startswith("[TRAIN]")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert "Finished step: 4/4" in out


def test_renderer_parity_mesh_matches_unsharded():
    """`NeRFRenderer(mesh=)` at precision "parity" shards the frame's rays
    (JAX renderer.py:156-165): the frame's bytes equal the unsharded one's."""
    from nerf_workspaces_explorer_tpu_torch.core.config import (
        ExperimentConfig,
        FrameworkConfig,
        InferenceConfig,
        RenderingConfig,
    )
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    cfg = FrameworkConfig(experiment=ExperimentConfig(image_width=16, image_height=8),
                          rendering=RenderingConfig(n_samples=4, n_importance=4, num_freqs_3d=6, num_freqs_2d=2),
                          inference=InferenceConfig(chunk=32))
    frames = []
    for mesh in (None, MESH):
        r = NeRFRenderer("office_tokyo", None, config=cfg, device="cpu" if mesh is None else None, mesh=mesh)
        r.initialize_models(allow_random_init=True, seed=3)
        frames.append(r.render_pose_uint8(np.eye(4, dtype=np.float32)).numpy())
    np.testing.assert_array_equal(frames[0], frames[1])


def test_dryrun_multigpu_small_spec():
    """`dryrun_multigpu` over 8 CPU shards at a small spec: every sharded
    leg equals its single-device counterpart to 5e-3 (on the CPU exactly),
    the data-parallel gradient its concatenated batch's, the K-step calls
    (`graph_steps`) the eager steps' losses, and its line printed."""
    from nerf_workspaces_explorer_tpu_torch.parallel.dryrun import dryrun_multigpu

    student = NerfMLPSpec(depth=2, width=32, input_ch=39, input_ch_views=27, skips=())
    report = dryrun_multigpu(devices=["cpu"] * N_DEV, spec=NerfMLPSpec(**SPEC),
                             settings=RenderSettings(**SETTINGS), student_spec=student, height=32, width=8, n_rays=64,
                             graph_steps=2)
    assert report["n_devices"] == N_DEV and report["plain_shape"] == (256, 3)
    assert np.isfinite(report["loss"]) and report["grad_rel"] < 1e-5
    assert report["loss"] == pytest.approx(report["loss_single"], rel=1e-5)
    assert report["fused_err"] < 5e-3
    assert report["graph_loss_err"] == 0.0  # on the CPU the K-step calls are the eager steps' body
    for leg in ("serving", "turbo", "stride"):
        assert report[f"{leg}_err"] == 0.0 and report[f"{leg}_bytes_equal"], leg
    assert all(not d for d in report["launches"].values())  # no kernel runs on the CPU
    with pytest.raises(ValueError, match="stride-4 row blocks"):
        dryrun_multigpu(devices=["cpu"] * 3, spec=NerfMLPSpec(**SPEC), height=32, width=8)
