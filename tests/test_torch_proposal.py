"""The proposal pass, the placement stride and the ray sort of the port's
fused path (plain versions on the CPU) against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.ops import pallas_render as jpr
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu.render import render_ray_bundle as jrender_ray_bundle
from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings
from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

torch.set_num_threads(2)

BF16_ATOL = 5e-3  # bf16 kernels (tests/test_golden.py:52)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)).copy()).to(dtype)


def _port_tree(params):
    return params_from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float32), params))


def _narrow_params(key, spec, boost):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    params = {"proposal": init_nerf_params(k1, jproposal_spec(6)), "fine": init_nerf_params(k2, spec)}
    for net in params.values():
        net["alpha"]["b"] = net["alpha"]["b"] + boost
    return params


def _kparams(params, fine_spec):
    tree = _port_tree(params)
    return {"proposal": fr.prepare_kernel_params(tree["proposal"], proposal_spec(6)),
            "fine": fr.prepare_kernel_params(tree["fine"], fine_spec)}


def test_narrow_spec_proposal_render_matches_jax():
    """tests/test_pallas.py:649: a 4x128 fine net behind the 2x64@6f proposal
    pass (the fused path's plain versions) against JAX's jnp pipeline."""
    params = _narrow_params(7, JSpec(depth=4, width=128), 1.5)
    settings = dict(n_samples=16, n_importance=16, use_proposal=True)
    rays = jcreate_rays(jnp.eye(4)[None], 8, 16, 8.0, 8.0, 7.5, 3.5, 0.5, 4.0).reshape(128)
    mine = fr.render_rays_fused(_kparams(params, NerfMLPSpec(depth=4, width=128)),
                                RayBundle(*(_t(f) for f in rays)), RenderSettings(**settings)).numpy()
    ref = jrender_ray_bundle(params, rays, JSettings(**settings).for_eval(), spec=JSpec(depth=4, width=128),
                             full_outputs=False)["rgb_fine"]
    np.testing.assert_allclose(mine, np.asarray(ref), atol=BF16_ATOL)


def test_proposal_subsample_corner_rays_exact():
    """tests/test_pallas.py:675: at stride 2 the block-corner rays keep their
    own placement exactly, the others stay close, no grid means exact
    placement; the strided render matches JAX's."""
    spec = dict(depth=2, width=128, input_ch=51)
    params = _narrow_params(3, JSpec(**spec), 2.0)
    h, w = 16, 32
    jrays = jcreate_rays(jnp.eye(4)[None], h, w, 16.0, 16.0, 15.5, 7.5, 0.1, 6.0).reshape(h * w)
    rays = RayBundle(*(_t(f) for f in jrays))
    settings = RenderSettings(n_samples=8, n_importance=8, num_freqs_3d=8, use_proposal=True, merge_coarse=False)
    kp = _kparams(params, NerfMLPSpec(**spec))
    exact = fr.render_rays_fused(kp, rays, settings, grid_hw=(h, w), early_stop_eps=0.0).numpy().reshape(h, w, 3)
    sub_settings = settings._replace(proposal_subsample=2)
    sub = fr.render_rays_fused(kp, rays, sub_settings, grid_hw=(h, w), early_stop_eps=0.0).numpy().reshape(h, w, 3)
    np.testing.assert_allclose(sub[::2, ::2], exact[::2, ::2], atol=1e-6)
    assert np.isfinite(sub).all() and np.abs(sub - exact).max() < 0.05
    fallback = fr.render_rays_fused(kp, rays, sub_settings, early_stop_eps=0.0).numpy().reshape(h, w, 3)
    np.testing.assert_array_equal(fallback, exact)
    ref = jpr.render_rays_fused(params, jrays, JSettings(**sub_settings._asdict()), spec=JSpec(**spec),
                                interpret=True, early_stop_eps=0.0, ray_tile=128, grid_hw=(h, w))
    np.testing.assert_allclose(sub.reshape(-1, 3), np.asarray(ref), atol=BF16_ATOL)


def test_sort_rays_is_exact():
    """tests/test_pallas.py:412: the saturation-ordered fine pass, unsorted
    back, equals the unsorted render (per-ray independence)."""
    params = _narrow_params(5, JSpec(depth=4, width=128), 1.5)
    rays = jcreate_rays(jnp.eye(4)[None], 8, 16, 8.0, 8.0, 7.5, 3.5, 0.5, 4.0).reshape(128)
    rays = RayBundle(*(_t(f) for f in rays))
    kp = _kparams(params, NerfMLPSpec(depth=4, width=128))
    settings = RenderSettings(n_samples=16, n_importance=16, use_proposal=True)
    base = fr.render_rays_fused(kp, rays, settings, early_stop_eps=1e-3).numpy()
    srt = fr.render_rays_fused(kp, rays, settings, early_stop_eps=1e-3, sort_rays=True).numpy()
    np.testing.assert_array_equal(srt, base)


def _histograms(seed, r=24, p=16, f=40):
    """Sorted proposal and fine depths with their weights: some proposal bins
    near zero (where the loss's 1 / (w + eps) is steep), a fine ray with all
    weight in one interval and one with none."""
    rng = np.random.default_rng(seed)
    z_prop = np.sort(rng.uniform(0.5, 4.0, (r, p)), -1).astype(np.float32)
    z_fine = np.sort(rng.uniform(0.5, 4.0, (r, f)), -1).astype(np.float32)
    w_prop = (rng.uniform(size=(r, p)) ** 3).astype(np.float32)
    w_prop[0, :4] = 1e-6
    w_fine = rng.dirichlet(np.full(f, 0.3), size=r).astype(np.float32) * 0.9
    w_fine[1] = 0.0
    w_fine[1, 7] = 1.0
    w_fine[2] = 0.0
    return z_prop, w_prop, z_fine, w_fine


@pytest.mark.parametrize("seed", [0, 1])
def test_interlevel_loss_and_gradient_match_jax(seed):
    """render/proposal.py::interlevel_loss against JAX's on numpy-seeded
    histograms: the value within rel 1e-6 and the gradient to w_prop within
    rel 1e-5 (fp32 on both sides, reduced in other orders); no gradient
    reaches the fine side (detached, as JAX stops it)."""
    from nerf_workspaces_explorer_tpu.render import proposal as jprop
    from nerf_workspaces_explorer_tpu_torch.render import proposal as prop

    z_prop, w_prop, z_fine, w_fine = _histograms(seed)
    jloss, jgrads = jax.value_and_grad(jprop.interlevel_loss, argnums=(1, 3))(
        *(jnp.asarray(x) for x in (z_prop, w_prop, z_fine, w_fine)))
    assert not np.asarray(jgrads[1]).any()
    t = [torch.from_numpy(x).requires_grad_(True) for x in (z_prop, w_prop, z_fine, w_fine)]
    loss = prop.interlevel_loss(*t)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    g_prop, g_fine, g_zfine = torch.autograd.grad(loss, [t[1], t[3], t[2]], allow_unused=True)
    assert g_fine is None and g_zfine is None
    ref = np.asarray(jgrads[0])
    assert float(np.abs(g_prop.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_interlevel_helpers_match_jax():
    """The gather-free edges, prefix and suffix weights, exactly."""
    from nerf_workspaces_explorer_tpu.render import proposal as jprop
    from nerf_workspaces_explorer_tpu_torch.render import proposal as prop

    z_prop, _, z_fine, w_fine = _histograms(2)
    lo, up = prop._sample_edges(torch.from_numpy(z_fine))
    jlo, jup = jprop._sample_edges(jnp.asarray(z_fine))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))
    q = torch.from_numpy(z_prop)
    cum = torch.cumsum(torch.from_numpy(w_fine), -1)
    np.testing.assert_allclose(prop._cumweight_at(up, cum, q).numpy(),
                               np.asarray(jprop._cumweight_at(jup, jnp.cumsum(jnp.asarray(w_fine), -1),
                                                              jnp.asarray(z_prop))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(prop._suffix_weight(lo, torch.from_numpy(w_fine), q).numpy(),
                               np.asarray(jprop._suffix_weight(jlo, jnp.asarray(w_fine), jnp.asarray(z_prop))),
                               rtol=1e-6, atol=1e-7)
