"""The port's ray generation, sampling, compositing and plain pipeline against
the JAX package and the golden render."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.rays import pack_rays as jpack_rays
from nerf_workspaces_explorer_tpu.rays import unpack_rays as junpack_rays
from nerf_workspaces_explorer_tpu.rays import sampling as jsampling
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu.render import render_rays_chunked as jrender_rays_chunked
from nerf_workspaces_explorer_tpu.render.volume import composite_rays as jcomposite
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLP, NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.rays import sampling
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle, create_rays, pack_rays, unpack_rays
from nerf_workspaces_explorer_tpu_torch.render.pipeline import (
    RenderSettings,
    render_ray_bundle,
    render_rays_chunked,
)
from nerf_workspaces_explorer_tpu_torch.render.volume import composite_rays

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_render.npz")
GOLDEN_SPEC = dict(depth=4, width=64, input_ch=39, input_ch_views=15)
GOLDEN_SETTINGS = dict(n_samples=16, n_importance=16, num_freqs_3d=6, num_freqs_2d=2)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def test_create_rays_matches_jax(rng):
    c2w = rng.normal(size=(2, 4, 4)).astype(np.float32)
    mine = create_rays(_t(c2w), 6, 10, 8.0, 8.5, 4.5, 2.5, 0.1, 10.0)
    ref = jcreate_rays(jnp.asarray(c2w), 6, 10, 8.0, 8.5, 4.5, 2.5, 0.1, 10.0)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_pack_rays_unpack_rays_batch_shape_match_jax(rng):
    """`pack_rays` gives JAX's [..., 11] records of the same seeded bundle
    bit for bit, `unpack_rays` returns the fields exactly (as JAX's does),
    and `RayBundle.batch_shape` is JAX's, before and after a reshape."""
    c2w = rng.normal(size=(2, 4, 4)).astype(np.float32)
    ref = jcreate_rays(jnp.asarray(c2w), 6, 10, 8.0, 8.5, 4.5, 2.5, 0.1, 10.0)
    mine = RayBundle(*(_t(f) for f in ref))
    packed = pack_rays(mine)
    assert packed.shape == (2, 60, 11)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack_rays(ref)))
    for a, b, c in zip(unpack_rays(packed), junpack_rays(jpack_rays(ref)), mine):
        assert torch.equal(a, c)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert mine.batch_shape == tuple(ref.batch_shape) == (2, 60)
    assert mine.reshape(120).batch_shape == tuple(ref.reshape(120).batch_shape) == (120,)
    assert unpack_rays(packed.reshape(120, 11)).batch_shape == (120,)


def test_coarse_z_vals_match_jax():
    near, far = np.full((5, 1), 0.1, np.float32), np.full((5, 1), 10.0, np.float32)
    for n in (16, 64):
        mine = sampling.coarse_z_vals(_t(near), _t(far), n).numpy()
        ref = np.asarray(jsampling.coarse_z_vals(jnp.asarray(near), jnp.asarray(far), n))
        np.testing.assert_array_equal(mine, ref)


def _weights_cases(rng):
    w = rng.uniform(size=(6, 62)).astype(np.float32)
    w[0] = 0.0  # all-zero weights: uniform pdf from the +1e-5 guard
    w[1, 10:40] = 0.0  # tied CDF entries (a flat stretch)
    w[2] = 0.0
    w[2, -1] = 1e3  # mass at the end: u >= cdf[-1] near u = 1
    w[3, :30] = 1e-20  # denominators under the 1e-5 guard
    return w


@pytest.mark.parametrize("n_samples", [2, 16, 128])
def test_sample_pdf_matches_jax(rng, n_samples):
    w = _weights_cases(rng)
    bins = np.sort(rng.uniform(0.1, 6.0, size=(6, 63)), axis=-1).astype(np.float32)
    bins[4, 20:25] = bins[4, 20]  # tied bins
    mine = sampling.sample_pdf(_t(bins), _t(w), n_samples).numpy()
    ref = np.asarray(jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n_samples))
    # Depths up to 6 through a CDF summed in another fp32 order: the golden
    # render's depth tolerance (tests/test_golden.py:41).
    np.testing.assert_allclose(mine, ref, atol=1e-4)
    assert np.all(np.diff(mine, axis=-1) >= 0)


def test_sample_pdf_clamps_past_the_last_cdf_entry():
    """u >= cdf[-1] takes the last bin: with all mass in the first bin, the
    CDF reaches ~1 after one step and the top quantile u = 1 lands on the last
    edge."""
    bins = _t(np.linspace(1.0, 2.0, 5)[None])
    w = _t([[1e6, 0.0, 0.0, 0.0]])
    z = sampling.sample_pdf(bins, w, 3).numpy()
    ref = np.asarray(jsampling.sample_pdf(jnp.asarray(bins.numpy()), jnp.asarray(w.numpy()), 3))
    np.testing.assert_allclose(z, ref, atol=1e-6)
    assert z[0, -1] == pytest.approx(2.0)


def test_merge_sorted_z_matches_jax(rng):
    a = np.sort(rng.uniform(size=(4, 8)), -1).astype(np.float32)
    b = np.sort(rng.uniform(size=(4, 5)), -1).astype(np.float32)
    b[0, 0] = a[0, 3]  # a tie across the two lists
    mine = sampling.merge_sorted_z(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(jsampling.merge_sorted_z(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("white", [False, True])
def test_composite_rays_matches_jax(rng, white):
    raw = rng.normal(size=(5, 12, 4)).astype(np.float32) * 3
    raw[0, :, 3] = -5.0  # acc = 0: disp stays finite
    z = np.sort(rng.uniform(0.1, 6, size=(5, 12)), -1).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    mine = composite_rays(_t(raw), _t(z), _t(d), white_background=white)
    ref = jcomposite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), white_background=white)
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        np.testing.assert_allclose(
            getattr(mine, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-5, rtol=1e-5
        )
    assert float(mine.acc[0]) == 0.0 and np.isfinite(mine.disp.numpy()).all()


def _golden_setup():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    spec = JSpec(**GOLDEN_SPEC)
    params = {"coarse": init_nerf_params(k1, spec), "fine": init_nerf_params(k2, spec)}
    for p in params.values():
        p["alpha"]["b"] = p["alpha"]["b"] + 1.5
    rays = jcreate_rays(jnp.eye(4)[None], 12, 16, 8.0, 8.0, 7.5, 5.5, 0.5, 4.0).reshape(192)
    return params, rays


def _port(params, rays):
    tree = params_from_numpy(jax.tree.map(np.asarray, params))
    models = {k: NerfMLP(v, NerfMLPSpec(**GOLDEN_SPEC)) for k, v in tree.items()}
    rays_t = RayBundle(*(_t(f) for f in rays))
    return models, rays_t


def test_plain_pipeline_matches_golden():
    """The port's fp32 pipeline reproduces the JAX package's golden render at
    its pinned tolerances (tests/test_golden.py:39-42)."""
    models, rays = _port(*_golden_setup())
    with torch.no_grad():
        out = render_ray_bundle(models, rays, RenderSettings(**GOLDEN_SETTINGS).for_eval(), full_outputs=True)
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(out["rgb_fine"].numpy(), golden["rgb_fine"], atol=1e-5)
    np.testing.assert_allclose(out["rgb_coarse"].numpy(), golden["rgb_coarse"], atol=1e-5)
    np.testing.assert_allclose(out["depth_fine"].numpy(), golden["depth_fine"], atol=1e-4)
    np.testing.assert_allclose(out["acc_fine"].numpy(), golden["acc_fine"], atol=1e-5)


def test_render_rays_chunked_matches_jax():
    """Chunking with edge padding (chunk 80 over 192 rays) against JAX."""
    params, rays = _golden_setup()
    models, rays_t = _port(params, rays)
    out = render_rays_chunked(models, rays_t, RenderSettings(**GOLDEN_SETTINGS), chunk=80)
    ref = jrender_rays_chunked(params, rays, JSettings(**GOLDEN_SETTINGS), spec=JSpec(**GOLDEN_SPEC), chunk=80)
    assert set(out) == {"rgb_fine", "disp_fine", "acc_fine", "depth_fine"}
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-5)
