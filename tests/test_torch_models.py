"""The port's config, camera, encoding, MLP, checkpoint and metrics modules
against the JAX package on the same inputs."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.camera import poses as jposes
from nerf_workspaces_explorer_tpu.core import config as jconfig
from nerf_workspaces_explorer_tpu.core.types import COORD as JCOORD
from nerf_workspaces_explorer_tpu.infer import checkpoint as jckpt
from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import apply_nerf_mlp, init_nerf_params
from nerf_workspaces_explorer_tpu.models.encoding import positional_encoding as jpe
from nerf_workspaces_explorer_tpu.utils import metrics as jmetrics
from nerf_workspaces_explorer_tpu_torch.camera import poses
from nerf_workspaces_explorer_tpu_torch.core import config
from nerf_workspaces_explorer_tpu_torch.core.types import COORD
from nerf_workspaces_explorer_tpu_torch.infer import checkpoint
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.encoding import (
    embedding_output_dim,
    positional_encoding,
)
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLP, NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.utils import metrics

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [
    os.path.join(ROOT, "assets", "bench", f)
    for f in ("synth_hier.npz", "room_proposal.npz", "room_proposal.turbo.npz")
]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("office", ["tokyo", "new_york", "geneve", "belgrade"])
def test_config_matches_jax(office):
    mine = dataclasses.asdict(config.load_config(office_name=office))
    ref = dataclasses.asdict(jconfig.load_config(office_name=office))
    assert mine == ref
    cfg, jcfg = config.load_config(office_name=office), jconfig.load_config(office_name=office)
    assert (cfg.fx, cfg.fy, cfg.cx, cfg.cy) == (jcfg.fx, jcfg.fy, jcfg.cx, jcfg.cy)


@pytest.mark.parametrize("expr,value", [("1024*8", 8192), ("32*32*1", 1024), (7, 7), (64.0, 64)])
def test_parse_int_expr(expr, value):
    assert config.parse_int_expr(expr) == value == jconfig.parse_int_expr(expr)


def test_parse_int_expr_rejects_code():
    with pytest.raises(ValueError):
        config.parse_int_expr("__import__('os')")


def test_poses_match_jax(rng):
    for _ in range(5):
        init = rng.uniform(-3, 3, size=6).tolist()
        deltas = [rng.uniform(-90, 90, size=6).tolist() for _ in range(3)]
        mine = poses.poses_from_coordinates(COORD(*init), [COORD(*d) for d in deltas])
        ref = jposes.poses_from_coordinates(JCOORD(*init), [JCOORD(*d) for d in deltas])
        np.testing.assert_array_equal(mine, ref)
    v = rng.normal(size=3)
    np.testing.assert_allclose(poses.rodrigues(v), jposes.rodrigues(v), atol=0)


@pytest.mark.parametrize("hw,hfov", [((240, 320), 90.0), ((12, 16), 90.0), ((480, 640), 60.0)])
def test_pinhole_intrinsics_match_jax(hw, hfov):
    """PinholeIntrinsics.from_hfov against the JAX package's, field for
    field (the same float64 arithmetic: exact)."""
    from nerf_workspaces_explorer_tpu.camera import PinholeIntrinsics as JIntrinsics
    from nerf_workspaces_explorer_tpu_torch.camera import PinholeIntrinsics

    mine, ref = PinholeIntrinsics.from_hfov(*hw, hfov), JIntrinsics.from_hfov(*hw, hfov)
    assert mine._fields == ref._fields and tuple(mine) == tuple(ref)


@pytest.mark.parametrize("num_freqs,factor", [(10, 10.0), (4, 1.0), (0, 1.0)])
def test_positional_encoding_matches_jax(rng, num_freqs, factor):
    x = rng.normal(size=(7, 5, 3)).astype(np.float32) * 3
    mine = positional_encoding(torch.from_numpy(x), num_freqs, factor).numpy()
    ref = np.asarray(jpe(jnp.asarray(x), num_freqs, scalar_factor=factor))
    assert mine.shape[-1] == embedding_output_dim(num_freqs)
    np.testing.assert_allclose(mine, ref, atol=1e-5)


@pytest.mark.parametrize(
    "spec_kwargs",
    [dict(), dict(depth=4, width=64, input_ch=39, input_ch_views=15)],
    ids=["8x256", "4x64"],
)
def test_mlp_matches_jax(rng, spec_kwargs):
    jspec, spec = JSpec(**spec_kwargs), NerfMLPSpec(**spec_kwargs)
    params = init_nerf_params(jax.random.PRNGKey(3), jspec)
    x = rng.normal(size=(33, spec.input_ch)).astype(np.float32)
    v = rng.normal(size=(33, spec.input_ch_views)).astype(np.float32)
    ref = np.asarray(apply_nerf_mlp(params, jspec, jnp.asarray(x), jnp.asarray(v)))
    model = NerfMLP(params_from_numpy(_np_tree(params)), spec)
    mine = model(torch.from_numpy(x), torch.from_numpy(v)).detach().numpy()
    np.testing.assert_allclose(mine, ref, atol=1e-5)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_npz_checkpoints_load_like_jax(path):
    mine, step, meta = checkpoint.load_checkpoint(path)
    ref, jstep, _, jmeta = jckpt.load_checkpoint(path)
    assert (step, meta) == (jstep, jmeta)
    flat_mine = jax.tree_util.tree_leaves_with_path(mine)
    flat_ref = jax.tree_util.tree_leaves_with_path(_np_tree(ref))
    assert [p for p, _ in flat_mine] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_mine, flat_ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("underscore", [True, False])
def test_torch_ckpt_loads_like_jax(tmp_path, underscore):
    spec = JSpec(depth=4, width=32, input_ch=39, input_ch_views=15)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    coarse, fine = init_nerf_params(k1, spec), init_nerf_params(k2, spec)
    path = str(tmp_path / "model.ckpt")
    to_t = lambda p: {  # noqa: E731
        k: torch.tensor(v) for k, v in jckpt.params_to_torch_state_dict(p, underscore=underscore).items()
    }
    torch.save(
        {"global_step": 9, "network_coarse_state_dict": to_t(coarse),
         "network_fine_state_dict": to_t(fine), "optimizer_state_dict": {}},
        path,
    )
    mc, mf, step = checkpoint.load_torch_checkpoint(path)
    rc, rf, jstep = jckpt.load_torch_checkpoint(path)
    assert step == jstep == 9
    for mine, ref in ((mc, rc), (mf, rf)):
        a, b = jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(_np_tree(ref))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_metrics_match_jax(rng):
    a = rng.uniform(size=(40, 50, 3))
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    assert metrics.ssim(a, b) == pytest.approx(jmetrics.ssim(a, b), abs=1e-9)
    assert metrics.ssim(a[..., 0], b[..., 0]) == pytest.approx(jmetrics.ssim(a[..., 0], b[..., 0]), abs=1e-9)
    x = rng.uniform(-0.2, 1.2, size=(9, 3)).astype(np.float32)
    np.testing.assert_array_equal(metrics.to8b(torch.from_numpy(x)), jmetrics.to8b(x))
    mse = metrics.img2mse(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(mse), float(jmetrics.img2mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(
        float(metrics.mse2psnr(torch.tensor(0.01))), float(jmetrics.mse2psnr(jnp.asarray(0.01))), rtol=1e-6
    )
