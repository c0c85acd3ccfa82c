"""One training step of the port against the JAX package's, on the CPU, with
the JAX package's own random draws handed to the port: the key path of
`make_train_step` (fold_in by step, split, `sample_training_rays`' randint
pair, `render_ray_bundle`'s split into perturb, coarse noise, fine noise and
importance keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.rays import sampling as jsampling
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu.render.volume import composite_rays as jcomposite
from nerf_workspaces_explorer_tpu.render.volume import sigma_to_weights as jsigma_to_weights
from nerf_workspaces_explorer_tpu.train import init_train_state as jinit_train_state
from nerf_workspaces_explorer_tpu.train import make_optimizer as jmake_optimizer
from nerf_workspaces_explorer_tpu.train.step import _loss_and_metrics as jloss_and_metrics
from nerf_workspaces_explorer_tpu.train.step import sample_training_rays as jsample_training_rays
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, tree_leaves
from nerf_workspaces_explorer_tpu_torch.rays import sampling
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderDraws, RenderSettings
from nerf_workspaces_explorer_tpu_torch.render.volume import composite_rays, sigma_to_weights
from nerf_workspaces_explorer_tpu_torch.train import step as tstep

torch.set_num_threads(2)

SPEC = dict(depth=4, width=64, input_ch=39, input_ch_views=15)
SETTINGS = dict(n_samples=16, n_importance=16, num_freqs_3d=6, num_freqs_2d=2, raw_noise_std=1.0)
N_RAYS = 64


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _jax_draws(key, step, n_img, hw, settings):
    """The draws `make_train_step`'s single step makes at `step`."""
    sample_key, render_key = jax.random.split(jax.random.fold_in(key, step))
    img_key, pix_key = jax.random.split(sample_key)
    img_idx = jax.random.randint(img_key, (), 0, n_img)
    pix_idx = jax.random.randint(pix_key, (N_RAYS,), 0, hw)
    k_perturb, k_noise_c, k_noise_f, k_imp = jax.random.split(render_key, 4)
    s, i = settings.n_samples, settings.n_importance
    render = RenderDraws(
        t_rand=_t(jax.random.uniform(k_perturb, (N_RAYS, s))),
        noise_coarse=_t(jax.random.normal(k_noise_c, (N_RAYS, s))),
        noise_fine=_t(jax.random.normal(k_noise_f, (N_RAYS, s + i if settings.merge_coarse else i))),
        u=_t(jax.random.uniform(k_imp, (N_RAYS, i))),
    )
    draws = tstep.StepDraws(torch.tensor(int(img_idx)), torch.from_numpy(np.array(pix_idx)).long(), render)
    return sample_key, render_key, draws


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(scale=0.3, size=(3, 3))
    rays = jcreate_rays(jnp.asarray(poses), 8, 8, 4.0, 4.0, 3.5, 3.5, 0.5, 4.0)
    rgbs = rng.uniform(size=(3, 64, 3)).astype(np.float32)
    return rays, rgbs


def test_one_step_loss_and_grads_match_jax(scene):
    """Loss rel 1e-5 and every gradient leaf rel 1e-4 from identical params
    and draws, on the f32 plain field."""
    rays, rgbs = scene
    jspec, jsettings = JSpec(**SPEC), JSettings(**SETTINGS)._replace(train=True)
    jstate = jinit_train_state(jax.random.PRNGKey(0), jspec, jmake_optimizer(5e-4))
    key = jax.random.PRNGKey(1)
    sample_key, render_key, draws = _jax_draws(key, 0, 3, 64, jsettings)
    sampled, gt = jsample_training_rays(sample_key, rays, jnp.asarray(rgbs), N_RAYS)

    def jloss(p):
        return jloss_and_metrics(p, sampled, gt, jsettings, jspec, render_key)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jstate.params)

    params = jax.tree.map(np.asarray, jstate.params)
    state = tstep.init_train_state(NerfMLPSpec(**SPEC), tstep.ExponentialDecay(), params=params)
    rays_t = RayBundle(*(_t(f) for f in rays))
    mine_rays, mine_gt = tstep.sample_training_rays(rays_t, _t(rgbs), draws.img_idx, draws.pix_idx)
    np.testing.assert_array_equal(mine_gt.numpy(), np.asarray(gt))
    settings = RenderSettings(**SETTINGS)._replace(train=True)
    loss, metrics = tstep.loss_and_metrics(state.params, mine_rays, mine_gt, settings,
                                           NerfMLPSpec(**SPEC), draws.render)
    grads = torch.autograd.grad(loss, tree_leaves(state.params))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("rgb_loss_coarse", "rgb_loss_fine", "psnr_fine"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    np.testing.assert_allclose(metrics["trans_fine"].numpy(), np.asarray(jm["trans_fine"]), atol=1e-4)
    ref = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(grads) == len(ref)
    for a, b in zip(grads, ref):
        rel = float(np.abs(a.numpy() - b).max() / (np.abs(b).max() + 1e-12))
        assert rel < 1e-4, rel


@pytest.mark.parametrize("merge_coarse", [True, False], ids=["merged", "fast-preset"])
def test_proposal_loss_and_grads_match_jax(scene, merge_coarse):
    """The proposal branch (JAX step.py:128-163: the interlevel loss between
    noiseless recomposited weights, psnr_coarse 0) from identical params and
    draws, with the fine net on merged or importance-only placement: the
    loss and each gradient leaf, proposal and fine, within rel 1e-4 of JAX
    (fp32 on both sides, summed in other orders)."""
    from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec

    rays, rgbs = scene
    jspec = JSpec(**SPEC)
    jsettings = JSettings(**SETTINGS, use_proposal=True, merge_coarse=merge_coarse)._replace(train=True)
    jstate = jinit_train_state(jax.random.PRNGKey(3), jspec, jmake_optimizer(5e-4),
                               proposal_spec=jproposal_spec(6))
    assert sorted(jstate.params) == ["fine", "proposal"]
    key = jax.random.PRNGKey(4)
    sample_key, render_key, draws = _jax_draws(key, 0, 3, 64, jsettings)
    sampled, gt = jsample_training_rays(sample_key, rays, jnp.asarray(rgbs), N_RAYS)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_and_metrics(p, sampled, gt, jsettings, jspec, render_key), has_aux=True)(jstate.params)

    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    state = tstep.init_train_state(NerfMLPSpec(**SPEC), tstep.ExponentialDecay(),
                                   params=jax.tree.map(np.asarray, jstate.params), proposal_spec=proposal_spec(6))
    assert sorted(state.params) == ["fine", "proposal"]
    rays_t = RayBundle(*(_t(f) for f in rays))
    mine_rays, mine_gt = tstep.sample_training_rays(rays_t, _t(rgbs), draws.img_idx, draws.pix_idx)
    settings = RenderSettings(**SETTINGS, use_proposal=True, merge_coarse=merge_coarse)._replace(train=True)
    loss, metrics = tstep.loss_and_metrics(state.params, mine_rays, mine_gt, settings, NerfMLPSpec(**SPEC),
                                           draws.render)
    grads = torch.autograd.grad(loss, tree_leaves(state.params))
    assert float(metrics["psnr_coarse"]) == float(jm["psnr_coarse"]) == 0.0
    for k in ("total_loss", "rgb_loss_coarse", "rgb_loss_fine"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    assert float(jm["rgb_loss_coarse"]) > 0.0
    ref = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(grads) == len(ref)
    for a, b in zip(grads, ref):
        rel = float(np.abs(a.numpy() - b).max() / (np.abs(b).max() + 1e-12))
        assert rel < 1e-4, rel


def test_train_step_updates_like_jax_step(scene):
    """`train_step` (draws, render, loss, backward, Adam at lr(0)) lands on
    the JAX step's parameters."""
    from nerf_workspaces_explorer_tpu.train import make_train_step

    rays, rgbs = scene
    jspec, jsettings = JSpec(**SPEC), JSettings(**SETTINGS)
    opt = jmake_optimizer(5e-3)
    jstate = jinit_train_state(jax.random.PRNGKey(2), jspec, opt)
    params = jax.tree.map(np.asarray, jstate.params)
    key = jax.random.PRNGKey(3)
    jstep = make_train_step(jsettings, jspec, opt, N_RAYS, donate=False)
    schedule = tstep.ExponentialDecay(5e-3)
    state = tstep.init_train_state(NerfMLPSpec(**SPEC), schedule, params=params)
    rays_t = RayBundle(*(_t(f) for f in rays))
    for step in range(2):
        _, _, draws = _jax_draws(key, step, 3, 64, jsettings._replace(train=True))
        jstate, jm = jstep(jstate, rays, jnp.asarray(rgbs), key)
        state, m = tstep.train_step(state, rays_t, _t(rgbs), draws, RenderSettings(**SETTINGS),
                                    NerfMLPSpec(**SPEC), schedule)
        assert float(m["total_loss"]) == pytest.approx(float(jm["total_loss"]), rel=1e-4)
    assert state.step == int(jstate.step) == 2
    for a, b in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)


def test_adam_and_schedule_match_optax():
    """torch Adam with the continuous decay against optax on the same
    gradients: parameters within 1e-7 after 3 updates."""
    rng = np.random.default_rng(1)
    params = {"coarse": {"w": rng.normal(size=(5, 4)).astype(np.float32)},
              "fine": {"b": rng.normal(size=(4,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params) for _ in range(3)]
    # The stock rate with a fast decay, so the schedule shows. (optax forms
    # Adam's bias corrections in f32, 1 - f32(0.999) being 1.3e-5 off: a
    # 6e-6 relative difference in each update, 3e-9 at this rate.)
    schedule = tstep.ExponentialDecay(5e-4, 0.1, 2.0)
    opt = jmake_optimizer(5e-4, 0.1, 2.0)
    jp, jopt = jax.tree.map(jnp.asarray, params), opt.init(jax.tree.map(jnp.asarray, params))
    tree = {k: {kk: torch.from_numpy(v.copy()).requires_grad_(True) for kk, v in d.items()}
            for k, d in params.items()}
    state = tstep.TrainState(tree, tstep.make_optimizer(tree, schedule), 0)
    for g in grads:
        updates, jopt = opt.update(jax.tree.map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, updates)
        for p, gl in zip(tree_leaves(tree), tree_leaves(g)):
            p.grad = torch.from_numpy(gl)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state = state._replace(step=state.step + 1)
    for a, b in zip(tree_leaves(tree), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-7)
    # The checkpoint layout of the Adam state is optax's flattened state.
    leaves = tstep.optimizer_leaves(state)
    ref = jax.tree_util.tree_leaves(jopt)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-12)  # lerp vs optax order


@pytest.mark.parametrize("step", [0, 25_000, 50_000, 100_000])
def test_lr_schedule_matches_reference_decay(step):
    # tests/test_train.py:149-155: lr * 0.1^(step/50000), continuous.
    schedule = tstep.ExponentialDecay(5e-4, 0.1, 50_000.0)
    expected = 5e-4 * 0.1 ** (step / 50_000.0)
    assert schedule(step) == pytest.approx(expected, rel=1e-6)
    ref = optax.exponential_decay(5e-4, 50_000.0, 0.1, staircase=False)
    assert schedule(step) == pytest.approx(float(ref(step)), rel=1e-6)


def test_stratified_perturb_matches_jax():
    z = jsampling.coarse_z_vals(jnp.full((7, 1), 0.5), jnp.full((7, 1), 4.0), 16)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jsampling.stratified_perturb(z, key))
    t_rand = _t(jax.random.uniform(key, z.shape))
    mine = sampling.stratified_perturb(_t(z), t_rand).numpy()
    np.testing.assert_allclose(mine, ref, atol=1e-5)


def test_random_sample_pdf_matches_jax():
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0.5, 4.0, size=(9, 15)), axis=-1).astype(np.float32)
    w = rng.uniform(size=(9, 14)).astype(np.float32)
    w[0] = 0.0  # the all-zero guard
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, key=key,
                                          deterministic=False))
    u = _t(jax.random.uniform(key, (9, 24)))
    mine = sampling.sample_pdf(_t(bins), _t(w), 24, u=u).numpy()
    np.testing.assert_allclose(mine, ref, atol=1e-5)


def test_noisy_composite_matches_jax():
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(6, 12, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 4.0, size=(6, 12)), axis=-1).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = jcomposite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), raw_noise_std=1.0, noise_key=key)
    noise = _t(jax.random.normal(key, (6, 12)))
    mine = composite_rays(_t(raw), _t(z), _t(d), raw_noise_std=1.0, noise=noise)
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        np.testing.assert_allclose(getattr(mine, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        sigma_to_weights(_t(raw[..., 3]), _t(z), _t(d)).numpy(),
        np.asarray(jsigma_to_weights(jnp.asarray(raw[..., 3]), jnp.asarray(z), jnp.asarray(d))),
        atol=1e-5,
    )


def test_training_render_needs_draws():
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import render_ray_bundle

    rays = RayBundle(torch.zeros(2, 3), torch.ones(2, 3), torch.full((2, 1), 0.5),
                     torch.full((2, 1), 4.0), torch.ones(2, 3))
    with pytest.raises(ValueError, match="requires draws"):
        render_ray_bundle({}, rays, RenderSettings(train=True))
