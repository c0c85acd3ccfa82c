"""The whole slice: floor-plan click -> frame through the port's Workspace and
NeRFRenderer on the CPU, against the JAX package, on the in-repo trained
8x256 coarse+fine checkpoint at a reduced frame size."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.app import workspace as jws
from nerf_workspaces_explorer_tpu.camera.poses import poses_from_coordinates as jposes
from nerf_workspaces_explorer_tpu.core.config import load_config as jload_config
from nerf_workspaces_explorer_tpu.infer.renderer import NeRFRenderer as JRenderer
from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.ops.pallas_render import render_rays_fused as jrender_fused
from nerf_workspaces_explorer_tpu.rays import create_rays as jcreate_rays
from nerf_workspaces_explorer_tpu.render import RenderSettings as JSettings
from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
from nerf_workspaces_explorer_tpu_torch.core.config import load_config
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
H, W = 8, 16  # 128 rays: one Pallas importance tile on the JAX side
CLICK = (0.35, 0.55, 30, -10)


def _small(load):
    cfg = load(office_name="tokyo")
    return dataclasses.replace(
        cfg,
        experiment=dataclasses.replace(cfg.experiment, image_width=W, image_height=H),
        inference=dataclasses.replace(cfg.inference, chunk=H * W),
    )


def test_parity_frame_matches_jax(capsys):
    renderer = NeRFRenderer("tokyo", CKPT, config=_small(load_config), precision="parity", device="cpu")
    renderer.initialize_models()
    mine = ws.OfficeTokyoWorkspace(renderer=renderer).render_image(*CLICK)
    jrenderer = JRenderer("tokyo", CKPT, config=_small(jload_config), precision="parity", use_pallas=False)
    jrenderer.initialize_models()
    ref = jws.OfficeTokyoWorkspace(renderer=jrenderer).render_image(*CLICK)
    assert mine.dtype == np.uint8 and mine.shape == ref.shape == (H, W, 3)
    assert np.abs(mine.astype(int) - ref.astype(int)).max() <= 1
    assert "Virtual camera coordinates" in capsys.readouterr().out


def test_fast_frame_matches_pallas_path():
    """precision="fast" on the CPU runs the kernels' plain versions: against
    JAX's render_rays_fused (interpret mode) on the same rays, with the
    renderer's early stop eps = 1e-3 on the JAX side."""
    renderer = NeRFRenderer("tokyo", CKPT, config=_small(load_config), precision="fast", device="cpu")
    renderer.initialize_models()
    init, coord = ws.OfficeTokyoWorkspace(renderer=renderer).transform_relative_coordinates(*CLICK)
    pose = jposes(init, [coord])[0]
    mine = renderer.render_pose(pose).numpy()

    cfg = _small(jload_config)
    jrenderer = JRenderer("tokyo", CKPT, config=cfg, precision="fast", use_pallas=False)
    jrenderer.initialize_models()  # casts the weights to bf16, as the TPU path serves them
    rays = jcreate_rays(
        jnp.asarray(pose)[None], H, W, cfg.fx, cfg.fy, cfg.cx, cfg.cy, *cfg.rendering.depth_range
    ).reshape(H * W)
    ref = jrender_fused(
        jrenderer.params, rays, JSettings(), spec=JSpec(), ray_tile=H * W,
        interpret=True, early_stop_eps=1e-3,
    )
    ref = np.asarray(ref).reshape(H, W, 3)
    np.testing.assert_allclose(mine, ref, atol=5e-3)  # bf16 bound (tests/test_golden.py:52)
    frame = renderer.render_pose_uint8(pose).numpy()
    np.testing.assert_array_equal(frame, np.floor(255 * np.clip(mine, 0, 1)).astype(np.uint8))


@pytest.mark.parametrize("office", sorted(ws.WORKSPACE_CLASSES))
def test_calibrations_match_jax(office):
    mine = ws.WORKSPACE_CLASSES[office](ckpt_path=CKPT, device="cpu")
    ref = jws.WORKSPACE_CLASSES[office](ckpt_path=CKPT)
    assert (mine.name, mine.office_name, mine.floor_plan_scale) == (ref.name, ref.office_name, ref.floor_plan_scale)
    for rel_x in np.linspace(0.0, 1.0, 6):
        for rel_y in np.linspace(0.0, 1.0, 6):
            for hor, ver in ((0, 0), (45, -20), (-130, 35)):
                a = mine.transform_relative_coordinates(rel_x, rel_y, hor, ver)
                b = ref.transform_relative_coordinates(rel_x, rel_y, hor, ver)
                assert [tuple(c) for c in a] == [tuple(c) for c in b]


def test_make_workspaces_order():
    names = [w.name for w in ws.make_workspaces(ckpt_path=CKPT, device="cpu")]
    assert names == [w.name for w in jws.make_workspaces(ckpt_path=CKPT)]


def test_two_yaws_differ():
    renderer = NeRFRenderer("tokyo", CKPT, config=_small(load_config), precision="fast", device="cpu")
    renderer.initialize_models()
    office = ws.OfficeTokyoWorkspace(renderer=renderer)
    a = office.render_image(0.5, 0.5, 0, 0)
    b = office.render_image(0.5, 0.5, 90, 0)
    assert a.shape == (H, W, 3) and not np.array_equal(a, b)
