"""The serving presets (fast, turbo) through the port's renderer, its preview
and its batch/stream paths, against the JAX package on the CPU at small
frame sizes (the proposal pass, stride and sort: tests/test_torch_proposal.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.core.config import load_config as jload_config
from nerf_workspaces_explorer_tpu.infer.renderer import NeRFRenderer as JRenderer
from nerf_workspaces_explorer_tpu.ops import pallas_render as jpr
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu.render import render_ray_bundle as jrender_ray_bundle
from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
from nerf_workspaces_explorer_tpu_torch.core.config import load_config
from nerf_workspaces_explorer_tpu_torch.core.types import COORD
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import render_ray_bundle

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
ROOM = os.path.join(ROOT, "assets", "bench", "room_proposal.npz")
BF16_ATOL = 5e-3  # bf16 kernels (tests/test_golden.py:52)
H, W = 8, 16  # 128 rays; the stride-4 lattice is 2 x 4
ROOM_POSE = poses_from_coordinates(COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0), [COORD(yaw=-30.0)])[0]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)).copy()).to(dtype)


def _small(load, depth_range=None):
    cfg = load(office_name="tokyo")
    rendering = cfg.rendering if depth_range is None else dataclasses.replace(cfg.rendering, depth_range=depth_range)
    return dataclasses.replace(
        cfg, rendering=rendering,
        experiment=dataclasses.replace(cfg.experiment, image_width=W, image_height=H),
        inference=dataclasses.replace(cfg.inference, chunk=H * W),
    )


def _jrays(cfg, pose, h=H, w=W):
    return jcreate_rays(jnp.asarray(pose)[None], h, w, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                        *cfg.rendering.depth_range).reshape(h * w)


PRESETS = {  # checkpoint, port and JAX renderer arguments
    "room-fast": (ROOM, dict(preset="fast", use_proposal=True)),
    "room-turbo": (ROOM, dict(preset="turbo")),
}


def _renderers(name, precision, depth_range=(0.1, 8.0)):
    ckpt, kw = PRESETS[name]
    mine = NeRFRenderer("tokyo", ckpt, config=_small(load_config, depth_range), precision=precision,
                        device="cpu", **kw)
    mine.initialize_models()
    ref = JRenderer("tokyo", ckpt, config=_small(jload_config, depth_range),
                    precision="fast" if precision == "int8" else precision, use_pallas=False, **kw)
    ref.initialize_models()
    return mine, ref


@pytest.mark.parametrize("name", list(PRESETS))
def test_fused_presets_match_jax(name):
    """The port's renderer at precision "fast" (plain versions on the CPU)
    against JAX's render_rays_fused (interpret mode) on the same rays with
    the same settings: the stride-4 lattice, 48 or 128 importance-only
    samples, the proposal pass."""
    mine, jr = _renderers(name, "fast")
    settings = JSettings(**{k: v for k, v in mine.settings._asdict().items() if k != "field_impl"})
    assert settings.proposal_subsample == 4 and not settings.merge_coarse and settings.use_proposal
    assert settings._replace(proposal_subsample=1) == jr._settings._replace(proposal_subsample=1, field_impl="xla")
    ref = jpr.render_rays_fused(jr.params, _jrays(_small(jload_config, (0.1, 8.0)), ROOM_POSE), settings,
                                spec=jr._spec, ray_tile=128, interpret=True, early_stop_eps=1e-3, grid_hw=(H, W))
    out = mine.render_pose(ROOM_POSE).numpy()
    np.testing.assert_allclose(out, np.asarray(ref).reshape(H, W, 3), atol=BF16_ATOL)


@pytest.mark.parametrize("name", list(PRESETS))
def test_parity_presets_match_jax(name):
    """The fp32 plain pipeline of the fast and turbo presets against JAX's
    parity renderer (tests/test_golden.py:39's 1e-5 for fp32 paths). The
    proposal weights agree to 1e-6 and every importance sample but the last
    to 1e-4. The last is the u = 1 quantile, which lands at either end of
    the final bin as cdf[-1] rounds under one summation order or the other
    (as K2's merged rows -3/-2, tests/test_torch_importance_merge.py); with
    importance-only placement it moves a few pixels' rgb by up to ~5e-4. So
    the frame agrees to 1e-5 on average and to 1e-3 everywhere."""
    mine, ref = _renderers(name, "parity")
    a, b = mine.render_pose(ROOM_POSE).numpy(), np.asarray(ref.render_pose(ROOM_POSE))
    assert np.abs(a - b).mean() <= 1e-5
    np.testing.assert_allclose(a, b, atol=1e-3)
    jrays = _jrays(_small(jload_config, (0.1, 8.0)), ROOM_POSE)
    with jax.default_matmul_precision("highest"):
        out = jrender_ray_bundle(ref.params, jrays, ref._settings, spec=ref._spec, full_outputs=True)
    rays = RayBundle(*(_t(f) for f in jrays))
    with torch.no_grad():
        outm = render_ray_bundle(mine._models, rays, mine.settings, full_outputs=True)
    np.testing.assert_allclose(outm["weights_coarse"].numpy(), np.asarray(out["weights_coarse"]), atol=1e-6)
    np.testing.assert_allclose(outm["z_vals_fine"].numpy()[:, :-1], np.asarray(out["z_vals_fine"])[:, :-1],
                               atol=1e-4)


def test_hier_preview_matches_jax_single_pass():
    """A coarse+fine checkpoint's preview: one pass of the coarse net at 64
    uniform depths, against JAX's render_rays_single_pass (interpret)."""
    cfg = _small(load_config)
    r = NeRFRenderer("tokyo", HIER, config=cfg, precision="fast", device="cpu")
    r.initialize_models()
    pose = np.eye(4, dtype=np.float32)
    rays = RayBundle(*(_t(f) for f in _jrays(_small(jload_config), pose)))
    mine = fr.render_rays_single_pass(r.kernel_params["coarse"], rays, r.settings, n_samples=64)
    jr = JRenderer("tokyo", HIER, config=_small(jload_config), precision="fast", use_pallas=False)
    jr.initialize_models()
    ref = jpr.render_rays_single_pass(jr.params["coarse"], _jrays(_small(jload_config), pose), jr._settings,
                                      spec=jr._spec, n_samples=64, ray_tile=128, interpret=True)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=BF16_ATOL)
    frame = r.render_pose_preview_uint8(pose).numpy()
    np.testing.assert_array_equal(frame, np.floor(255 * np.clip(mine.numpy().reshape(H, W, 3), 0, 1)))


def test_turbo_preview_matches_jax():
    """A proposal checkpoint's preview: the proposal pass at 64 samples and
    an importance-only student pass at 32, exact placement, against JAX's
    render_rays_fused with the same settings."""
    mine, jr = _renderers("room-turbo", "fast")
    frame = mine.render_pose_preview_uint8(ROOM_POSE).numpy()
    prop = jr._settings.for_eval()._replace(n_samples=64, n_importance=32, merge_coarse=False)
    ref = jpr.render_rays_fused(jr.params, _jrays(_small(jload_config, (0.1, 8.0)), ROOM_POSE), prop,
                                spec=jr._spec, ray_tile=128, interpret=True, early_stop_eps=1e-3)
    ref = np.floor(255 * np.clip(np.asarray(ref).reshape(H, W, 3), 0, 1))
    assert np.abs(frame.astype(int) - ref.astype(int)).max() <= 2  # bf16 5e-3 is ~1.3 levels


def test_stream_and_batch_equal_per_pose():
    """render_poses_uint8_stream frames equal per-pose render_pose_uint8
    frames to the bit; render_poses agrees with per-pose render_pose."""
    mine = NeRFRenderer("tokyo", ROOM, config=_small(load_config, (0.1, 8.0)), precision="fast", preset="turbo",
                        device="cpu")
    mine.initialize_models()
    poses = poses_from_coordinates(COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0),
                                   [COORD(yaw=a) for a in (-40.0, -10.0, 20.0, 50.0)])
    stream = list(mine.render_poses_uint8_stream(poses, lookahead=2))
    assert len(stream) == 4
    for frame, pose in zip(stream, poses):
        np.testing.assert_array_equal(frame, mine.render_pose_uint8(pose).numpy())
    # One bundle of four frames. On the CPU the matmuls of another shape sum
    # in another order, so a bf16 activation may round the other way; with
    # importance-only placement that can move the u = 1 sample, so the
    # batch is held at the reference preset's merged placement.
    hier = NeRFRenderer("tokyo", HIER, config=_small(load_config), precision="fast", device="cpu")
    hier.initialize_models()
    batch = hier.render_poses(poses)
    assert batch.shape == (4, H, W, 3)
    np.testing.assert_allclose(batch, np.stack([hier.render_pose(p).numpy() for p in poses]), atol=BF16_ATOL)


def test_turbo_requires_sidecar(tmp_path):
    """tests/test_distill.py:215."""
    with pytest.raises(RuntimeError, match="turbo sidecar"):
        NeRFRenderer("tokyo", str(tmp_path / "missing.npz"), preset="turbo", device="cpu")
    with pytest.raises(ValueError, match="requires a checkpoint"):
        NeRFRenderer("tokyo", None, preset="turbo", device="cpu")


def test_random_init_and_set_params_recalibrate():
    """Random weights from an explicit generator for a proposal renderer;
    set_params installs other weights and recalibrates int8."""
    cfg = _small(load_config)
    r = NeRFRenderer("tokyo", None, config=cfg, precision="int8", preset="fast", use_proposal=True, device="cpu")
    r.initialize_models(allow_random_init=True, generator=torch.Generator().manual_seed(1))
    assert set(r.params) == {"proposal", "fine"} and set(r.quant) == {"proposal", "fine"}
    assert r.kernel_params["proposal"].width == 64 and r.kernel_params["fine"].int8_heads
    frame = r.render_pose_uint8(np.eye(4, dtype=np.float32)).numpy()
    assert frame.shape == (H, W, 3)
    before = r.quant["fine"]
    tree = {k: {**v, "pts": [{"w": 2 * layer["w"], "b": layer["b"]} for layer in v["pts"]]}
            for k, v in r.params.items()}
    r.set_params(tree)
    assert r.quant["fine"].w_max == tuple(2 * m for m in before.w_max)
    with pytest.raises(ValueError, match="use_proposal=True"):
        NeRFRenderer("tokyo", ROOM, config=cfg, device="cpu").initialize_models()


def test_workspace_preview_and_make_workspaces():
    cfg = _small(load_config)
    r = NeRFRenderer("tokyo", HIER, config=cfg, precision="int8-trunk", device="cpu")
    r.initialize_models()
    office = ws.OfficeTokyoWorkspace(renderer=r)
    click = (0.4, 0.6, 20, -5)
    init, coord = office.transform_relative_coordinates(*click)
    np.testing.assert_array_equal(office.render_image_preview(*click), r.render_coordinates_preview(init, coord))
    for w in ws.make_workspaces(ckpt_path=ROOM, precision="int8", preset="fast", device="cpu"):
        assert w.renderer.settings.merge_coarse is False
        assert w.renderer._precision == "int8"
