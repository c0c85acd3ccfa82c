"""The int8 modes of the fused render kernel's plain version (K7) against the
JAX package: its Pallas kernel in interpret mode, its integer trunk, and the
fp32 pipeline."""

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
from nerf_workspaces_explorer_tpu.ops import quantize as jq
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.ops import quantize as q
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings, render_ray_bundle

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-3  # rgb and weights against JAX's int8 kernel


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)).copy()).to(dtype)


def _port_tree(params):
    return params_from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float32), params))


@pytest.fixture(scope="module")
def hier():
    """The in-repo trained 8x256 coarse+fine checkpoint (skip at layer 4)."""
    params, _, _, _ = jload_checkpoint(os.path.join(ROOT, "assets", "bench", "synth_hier.npz"))
    return params


def _inputs(n_rays=128, n_samples=16):
    rng = np.random.default_rng(0)
    o = rng.normal(scale=0.5, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(n_samples, n_rays)), axis=0).astype(np.float32)
    o_ph, d_ph = jpr.ray_phase_vectors(jnp.asarray(o), jnp.asarray(d))
    dists = jpr._dists_from_z(jnp.asarray(z), jnp.linalg.norm(jnp.asarray(d), axis=-1)[None])
    return o_ph, d_ph, jnp.asarray(z), dists, jpr.encode_viewdirs_kernel_order(jnp.asarray(v))


def _kernel_params(net, heads):
    spec = jq.spec_from_net_params(net)
    ref = jpr.prepare_kernel_params(net, spec, quant=jq.calibrate_trunk(net, spec, heads=heads))
    mine = fr.prepare_kernel_params(_port_tree(net), NerfMLPSpec(*spec),
                                    quant=q.calibrate_trunk(_port_tree(net), NerfMLPSpec(*spec), heads=heads))
    return mine, ref


@pytest.mark.parametrize("heads", [True, False], ids=["int8", "int8-trunk"])
@pytest.mark.parametrize("density_only", [True, False], ids=["density", "full"])
def test_int8_plain_matches_pallas_kernel(hier, heads, density_only):
    """Both int8 modes, density-only (coarse) and full (fine, a skip layer),
    against `nerf_render_pallas(interpret=True)` at eps 0: rgb and weights
    within 2e-3, and at least 98% of the rays equal to 1e-6. The rest differ
    by an int8 encoding level: the interpreted kernel runs under jit, where
    XLA contracts the fp32 sin/cos ladder into FMAs (12 of the 131,072
    quantized features of these inputs round to another level than the
    unfused chain the port and its CUDA kernel compute)."""
    net = hier["coarse" if density_only else "fine"]
    kp, kpj = _kernel_params(net, heads)
    o_ph, d_ph, z, dists, venc = _inputs()
    ref = np.asarray(jpr.nerf_render_pallas(
        kpj, o_ph, d_ph, z, dists, None if density_only else venc, density_only=density_only,
        ray_tile=128, early_stop_eps=0.0, interpret=True,
    ))
    mine = fr.nerf_render(
        kp, _t(o_ph), _t(d_ph), _t(z), _t(dists), None if density_only else _t(venc, torch.bfloat16),
        density_only=density_only,
    ).numpy()
    rows = slice(None) if density_only else [0, 1, 2, 4]
    err = np.abs(mine[rows] - ref[rows])
    assert mine.shape == ref.shape and np.isfinite(mine).all()
    assert err.max() <= ATOL, err.max()
    assert (err.max(0) <= 1e-6).mean() >= 0.98, (err.max(0) <= 1e-6).mean()


@pytest.mark.parametrize("heads", [True, False], ids=["int8", "int8-trunk"])
def test_int8_trunk_equals_jax_trunk(hier, heads):
    """On the same int8 encodings, the port's integer trunk (int32 epilogues,
    float64-exact products, the skip product shifted) equals JAX's `_trunk`
    to the bit: int8 activations, or int8-trunk's bf16 last layer."""
    kp, kpj = _kernel_params(hier["fine"], heads)
    o_ph, d_ph, z, _, _ = _inputs(n_rays=64, n_samples=4)
    p = _t(o_ph)[:3].T[:, None, :] + _t(z).T[..., None] * _t(d_ph)[:3].T[:, None, :]
    feat = fr._quantize_feat(fr._encode_ladder(p, 10), kp.feat_qscale)  # [R, S, 64]
    mine = fr._trunk_plain(kp, feat).float().numpy()
    flat = jnp.asarray(feat.reshape(-1, 64).T.numpy().astype(np.int8))
    ref = jpr._trunk(flat, kpj.w_layers, kpj.w_skip_enc, kpj.b_layers, kpj.skips, jnp.bfloat16,
                     kpj.shift_layers, kpj.skip_shift, int8_out=heads)
    np.testing.assert_array_equal(mine.reshape(-1, mine.shape[-1]).T, np.asarray(ref, np.float32))


@pytest.fixture(scope="module")
def random_params():
    """tests/test_pallas.py's fixture: 8x256 random nets with visible density."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    p = {"coarse": init_nerf_params(k1, JSpec()), "fine": init_nerf_params(k2, JSpec())}
    for net in p.values():
        net["alpha"]["b"] = net["alpha"]["b"] + 1.5
    return p


@pytest.mark.parametrize("heads", [True, False], ids=["int8", "int8-trunk"])
def test_int8_fused_render_matches_fp32_pipeline(random_params, heads):
    """The port's int8 fused render against its own fp32 pipeline, on
    tests/test_pallas.py:408's setup: mean error < 4e-3, max < 4e-2."""
    tree = _port_tree(random_params)
    quant = q.calibrate_model_quant(tree, NerfMLPSpec(), box=4.0, heads=heads)
    kparams = {k: fr.prepare_kernel_params(v, NerfMLPSpec(), quant=quant[k]) for k, v in tree.items()}
    rays = jcreate_rays(jnp.eye(4)[None], 8, 16, 8.0, 8.0, 7.5, 3.5, 0.5, 4.0).reshape(128)
    rays = RayBundle(*(_t(f) for f in rays))
    settings = RenderSettings(n_samples=16, n_importance=16)
    rgb = fr.render_rays_fused(kparams, rays, settings).numpy()
    ref = render_ray_bundle(tree, rays, settings.for_eval(), spec=NerfMLPSpec())["rgb_fine"].numpy()
    err = np.abs(rgb - ref)
    assert rgb.shape == (128, 3) and np.isfinite(rgb).all()
    assert err.mean() < 4e-3, err.mean()
    assert err.max() < 4e-2, err.max()
