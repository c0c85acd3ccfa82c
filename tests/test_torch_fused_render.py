"""The fused render path's plain versions against the JAX package's Pallas
kernel, run as tests/test_pallas.py runs it (interpret mode on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.infer.checkpoint import load_checkpoint as jload_checkpoint
from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.ops import pallas_render as jpr
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_render.npz")
SMALL = dict(depth=4, width=64, input_ch=39, input_ch_views=15)
BF16_ATOL = 5e-3  # bf16 weights and activations (tests/test_golden.py:51-52)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)).copy()).to(dtype)


@pytest.fixture(scope="module")
def hier():
    """The in-repo trained 8x256 coarse+fine checkpoint, bf16 as served."""
    params, _, _, _ = jload_checkpoint(os.path.join(ROOT, "assets", "bench", "synth_hier.npz"))
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)


def _port_tree(params):
    return params_from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float32), params))


@pytest.mark.parametrize("spec_kwargs", [dict(), SMALL], ids=["8x256", "4x64"])
def test_prepare_kernel_params_matches_jax(hier, spec_kwargs):
    jspec = JSpec(**spec_kwargs)
    params = hier["fine"] if not spec_kwargs else init_nerf_params(jax.random.PRNGKey(0), jspec)
    ref = jpr.prepare_kernel_params(params, jspec)
    kp = fr.prepare_kernel_params(_port_tree(params), NerfMLPSpec(**spec_kwargs))
    w = kp.width
    assert kp.skips == ref.skips and (kp.pts_freqs, kp.view_freqs) == (ref.pts_freqs, ref.view_freqs)
    pairs = list(zip(kp.w_layers, ref.w_layers)) + list(zip(kp.w_skip_enc, ref.w_skip_enc))
    pairs += [(b, rb[:, 0]) for b, rb in zip(kp.b_layers, ref.b_layers)]
    pairs += [(kp.w_fa, ref.w_fa), (kp.b_fa, ref.b_fa[:, 0]), (kp.w_view_h, ref.w_view_h),
              (kp.w_view_enc, ref.w_view_enc), (kp.b_view, ref.b_view[:, 0]),
              (kp.w_rgb[:8], ref.w_rgb), (kp.b_rgb[:8], ref.b_rgb[:, 0])]
    for mine, theirs in pairs:
        np.testing.assert_array_equal(mine.float().numpy(), np.asarray(theirs, np.float32))
    assert not kp.w_rgb[3:].any() and kp.w_fa.shape[0] >= w + 16


def test_phase_vectors_and_view_encoding_match_jax(rng):
    o = rng.normal(size=(9, 3)).astype(np.float32)
    d = rng.normal(size=(9, 3)).astype(np.float32)
    for mine, ref in zip(fr.ray_phase_vectors(_t(o), _t(d)), jpr.ray_phase_vectors(jnp.asarray(o), jnp.asarray(d))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-6)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mine = fr.encode_viewdirs_kernel_order(_t(v)).float().numpy()
    ref = np.asarray(jpr.encode_viewdirs_kernel_order(jnp.asarray(v)), np.float32)
    np.testing.assert_array_equal(mine, ref)


def test_sincos_poly_and_ladder_match_jax(rng):
    p = rng.uniform(-4, 4, size=(3, 500)).astype(np.float32)
    s, c = fr._sincos_poly(_t(p))
    js, jc = jpr._sincos_poly(jnp.asarray(p))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-7)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_allclose(s.numpy(), np.sin(p), atol=2e-7)
    mine = fr._encode_ladder(_t(p.T), 10).numpy().T
    ref = np.asarray(jpr._encode_ladder(jnp.asarray(p), 10, jnp.float32))
    assert mine.shape == ref.shape == (64, 500)
    np.testing.assert_allclose(mine, ref, atol=1e-5)


def _kernel_inputs(rng, n_rays, n_samples):
    o = rng.normal(scale=0.5, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n_samples, n_rays)), axis=0).astype(np.float32)
    o_ph, d_ph = jpr.ray_phase_vectors(jnp.asarray(o), jnp.asarray(d))
    zj = jnp.asarray(z)
    dists = jpr._dists_from_z(zj, jnp.linalg.norm(jnp.asarray(d), axis=-1)[None])
    venc = jpr.encode_viewdirs_kernel_order(jnp.asarray(v))
    return o_ph, d_ph, zj, dists, venc


@pytest.mark.parametrize("density_only", [True, False], ids=["coarse-density", "fine-full"])
def test_nerf_render_plain_matches_pallas_kernel(hier, rng, density_only):
    """The plain version of the CUDA kernel against the TPU kernel, both
    modes, 8x256 trained weights, early stop off on both sides."""
    net = hier["coarse"] if density_only else hier["fine"]
    o_ph, d_ph, z, dists, venc = _kernel_inputs(rng, 128, 16)
    ref = jpr.nerf_render_pallas(
        jpr.prepare_kernel_params(net, JSpec()), o_ph, d_ph, z, dists,
        None if density_only else venc, density_only=density_only,
        ray_tile=128, early_stop_eps=0.0, interpret=True,
    )
    kp = fr.prepare_kernel_params(_port_tree(net), NerfMLPSpec())
    mine = fr.nerf_render(
        kp, _t(o_ph), _t(d_ph), _t(z), _t(dists),
        None if density_only else _t(venc, torch.bfloat16), density_only=density_only,
    )
    ref = np.asarray(ref)
    rows = slice(None) if density_only else slice(0, 5)
    np.testing.assert_allclose(mine.numpy()[rows], ref[rows], atol=BF16_ATOL)
    assert mine.shape == ref.shape


def _golden_setup():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    spec = JSpec(**SMALL)
    params = {"coarse": init_nerf_params(k1, spec), "fine": init_nerf_params(k2, spec)}
    for p in params.values():
        p["alpha"]["b"] = p["alpha"]["b"] + 1.5
    rays = jcreate_rays(jnp.eye(4)[None], 12, 16, 8.0, 8.0, 7.5, 5.5, 0.5, 4.0).reshape(192)
    return params, rays


def test_render_rays_fused_matches_golden_and_pallas():
    """The fused path (plain versions on the CPU) against the golden render
    and against JAX's render_rays_fused in interpret mode."""
    params, rays = _golden_setup()
    settings = dict(n_samples=16, n_importance=16, num_freqs_3d=6, num_freqs_2d=2)
    kparams = {k: fr.prepare_kernel_params(v, NerfMLPSpec(**SMALL)) for k, v in _port_tree(params).items()}
    out = fr.render_rays_fused(
        kparams, RayBundle(*(_t(f) for f in rays)), RenderSettings(**settings), full=True
    )
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(out.rgb.numpy(), golden["rgb_fine"], atol=BF16_ATOL)
    ref = jpr.render_rays_fused(
        params, rays, JSettings(**settings), spec=JSpec(**SMALL), ray_tile=192,
        interpret=True, full=True, early_stop_eps=0.0,
    )
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), atol=BF16_ATOL)
    np.testing.assert_allclose(out.acc.numpy(), np.asarray(ref.acc), atol=BF16_ATOL)
    # Depth sums weights times z (up to 4 here): the bf16 bound scaled by far.
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), atol=4 * BF16_ATOL)
    assert np.isfinite(out.disp.numpy()).all()


def test_kernel_refuses_other_specs():
    """The CUDA kernel is built for the in-repo checkpoints' shapes (64/F=6
    density-only, 128/F=8, 192/F=10, 256/F=10); other specs raise instead of
    launching: width 320, F=12, and the proposal shape's full pass."""
    for spec_kwargs, density_only in ((dict(width=320), True), (dict(input_ch=75), True), (SMALL, False)):
        params = init_nerf_params(jax.random.PRNGKey(0), JSpec(**spec_kwargs))
        kp = fr.prepare_kernel_params(_port_tree(params), NerfMLPSpec(**spec_kwargs))
        with pytest.raises(ValueError, match="built for width/point frequencies"):
            fr._check_kernel_params(kp, torch.device("cpu"), density_only)
