"""mip-NeRF 360 on the CPU: the renderer's eager `mipnerf360` path against
the plain float32 reference (`benchmark/reference/mipnerf360.py`, which
imports nothing of the port) at a small size (nets cut to 8x64 and 4x32, a
16x12 frame, seeded weights), the click path through
`Workspace.render_image`, the seeded draw bit-equal to the reference's, and
the pieces against what they compute: the
frustum's moments by numerical integration, the contraction's Jacobian by
autograd, the encoding at zero variance, max-dilation on a step function
worked by hand, the basis, the kernels' slab layout, and what a traced
frame counts and marks. The kernels themselves need the card
(`tests/test_torch_gpu.py -k m360`)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu_torch.app.workspace import OfficeTokyoWorkspace
from nerf_workspaces_explorer_tpu_torch.core.config import load_config
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import SEEDED_FORMAT, load_seeded_checkpoint
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
from nerf_workspaces_explorer_tpu_torch.models import encoding
from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import Mip360Spec, basis
from nerf_workspaces_explorer_tpu_torch.ops import mipnerf360 as m3
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDED = os.path.join(ROOT, "assets", "bench", "mipnerf360_seeded.json")
SMALL = Mip360Spec(nerf_width=64, prop_width=32, bottleneck=32, view_width=16)
H, W = 12, 16


def _reference():
    path = os.path.join(ROOT, "benchmark", "reference", "mipnerf360.py")
    mod_spec = importlib.util.spec_from_file_location("bench_reference_mipnerf360", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


plain = _reference()


def _checkpoint(tmp_path, seed=7):
    path = tmp_path / "m360.json"
    path.write_text(json.dumps({"format": SEEDED_FORMAT, "seed": seed, "spec": SMALL.to_dict()}))
    return str(path)


def _renderer(tmp_path):
    cfg = load_config(office_name="office_tokyo")
    cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(cfg.experiment, image_width=W, image_height=H))
    r = NeRFRenderer("office_tokyo", _checkpoint(tmp_path), config=cfg, precision="fast", preset="mipnerf360",
                     device="cpu")
    r.initialize_models()
    return r, cfg


def _pose():
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.6, -0.5, 0.3]
    return pose


def test_eager_path_matches_plain_reference(tmp_path):
    r, cfg = _renderer(tmp_path)
    rgb = r.render_pose(_pose()).reshape(-1, 3)
    rays = create_rays(torch.as_tensor(_pose()), H, W, cfg.fx, cfg.fy, cfg.cx, cfg.cy, 0.1, 10.0).reshape(H * W)
    grid = rays.dirs.reshape(H, W, 3)
    dx = torch.linalg.norm(grid[:, 1:] - grid[:, :-1], dim=-1)
    radii = (torch.cat([dx, dx[:, -1:]], -1) * (2 / np.sqrt(12))).reshape(-1)
    s = np.float32(SMALL.scene_scale)
    ref = plain.render_rays(plain.init_params(7, SMALL.to_dict()), rays.origins / s, rays.dirs / s, rays.viewdirs,
                            radii / s, SMALL.to_dict())
    err = (rgb - ref).abs()
    # the port rounds every product's operands and each layer's output to
    # bf16 (2^-9 relative): colours move by ~4e-4 on average, 2e-3 at most
    # (measured), and placement follows the proposal's rounding
    assert err.mean().item() < 1e-3
    assert err.max().item() < 1e-2


def test_click_path_serves_mipnerf360(tmp_path):
    r, _ = _renderer(tmp_path)
    space = OfficeTokyoWorkspace(renderer=r)
    a = space.render_image(0.5, 0.6, 30, 0)
    b = space.render_image(0.5, 0.6, 120, 0)
    assert a.shape == (H, W, 3) and a.dtype == np.uint8
    assert not np.array_equal(a, b)
    assert np.array_equal(space.render_image_preview(0.5, 0.6, 30, 0), a)


def test_preset_refuses_other_precisions_and_a_missing_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="mipnerf360"):
        NeRFRenderer("office_tokyo", SEEDED, precision="parity", preset="mipnerf360", device="cpu")
    r = NeRFRenderer("office_tokyo", str(tmp_path / "none.json"), precision="fast", preset="mipnerf360",
                     device="cpu")
    with pytest.raises(RuntimeError, match="cannot be found"):
        r.initialize_models()


def test_seeded_draw_matches_the_benchmark_reference():
    tree, spec, _ = load_seeded_checkpoint(SEEDED)
    assert spec == Mip360Spec()  # the published widths
    params, ref_spec = plain.load(SEEDED, "cpu")
    assert ref_spec == spec.to_dict()
    for net, layers in tree.items():
        named = {f"trunk{i}": leaf for i, leaf in enumerate(layers["trunk"])}
        named.update({k: v for k, v in layers.items() if k != "trunk"})
        assert sorted(named) == sorted(params[net])
        for name, leaf in named.items():
            assert np.array_equal(leaf["w"], params[net][name][0].numpy()), (net, name)
            assert np.array_equal(leaf["b"], params[net][name][1].numpy()), (net, name)
    assert tree["nerf"]["trunk"][5]["w"].shape == (1024 + 504, 1024)
    lim = np.sqrt(6.0 / 1024)
    assert 0.99 * lim < np.abs(tree["nerf"]["trunk"][3]["w"]).max() <= lim


def test_frustum_moments_match_numerical_integration():
    """A cone's cross-section grows as t^2: the distance's mean and variance
    and a unit-radius disc's per-axis variance t^2 / 4, as integrals over
    [t0, t1] with density t^2 (float64, Simpson's rule at 20,001 points)."""
    t0 = torch.tensor([0.1, 0.5, 2.0, 10.0, 3.0], dtype=torch.float64)
    t1 = torch.tensor([0.2, 0.51, 5.0, 1000.0, 3.0001], dtype=torch.float64)
    t_mean, t_var, r_var = encoding.frustum_moments(t0, t1)
    for i in range(len(t0)):
        t = np.linspace(float(t0[i]), float(t1[i]), 20001)
        wts = np.ones_like(t)
        wts[1:-1:2], wts[2:-1:2] = 4, 2
        dens = wts * t**2

        def mean(f):
            return (dens * f).sum() / dens.sum()

        m = mean(t)
        # relative 1e-7: Simpson's error at this step, and the stable form's
        # rounding where the interval is short against its distance
        assert float(t_mean[i]) == pytest.approx(m, rel=1e-7)
        assert float(t_var[i]) == pytest.approx(mean((t - m) ** 2), rel=1e-5, abs=1e-12)
        assert float(r_var[i]) == pytest.approx(mean(t**2) / 4, rel=1e-7)


def test_contraction_jacobian_matches_autograd():
    g = torch.Generator().manual_seed(0)
    means = torch.randn(64, 3, generator=g, dtype=torch.float64) * 1.5  # inside and outside the ball
    a = torch.randn(64, 3, 3, generator=g, dtype=torch.float64)
    covs = a @ a.transpose(-1, -2) * 0.01
    z, cov_c = encoding.contract_gaussian(means, covs)
    for i in range(len(means)):
        jac = torch.autograd.functional.jacobian(encoding.contract, means[i])
        # float64 throughout: agreement to rounding
        torch.testing.assert_close(z[i], encoding.contract(means[i]), rtol=0, atol=1e-12)
        torch.testing.assert_close(cov_c[i], jac @ covs[i] @ jac.T, rtol=1e-10, atol=1e-12)
    outside = means.norm(dim=-1) > 1
    assert bool(outside.any()) and bool((~outside).any())
    assert bool((z.norm(dim=-1) < 2).all())


def test_zero_variance_encoding_is_the_sine_encoding_on_the_basis():
    g = torch.Generator().manual_seed(1)
    x = torch.rand(100, 3, generator=g) * 4 - 2
    b = torch.as_tensor(basis(), dtype=torch.float32)
    enc = encoding.integrated_pos_enc(x, torch.zeros(100, 3, 3), b, 12)
    m = x @ b.T
    scaled = (m[:, None, :] * 2.0 ** torch.arange(12.0)[:, None]).flatten(1)
    # exp(0) = 1: the same arithmetic, exactly
    torch.testing.assert_close(enc, torch.cat([torch.sin(scaled), torch.cos(scaled)], -1), rtol=0, atol=0)
    assert enc.shape == (100, 504)


def test_max_dilation_on_a_step_function_worked_by_hand():
    """Edges [0, .5, 1], weights [.75, .25] (densities 1.5, .5), dilated by
    .1: the edges' union with [-.1, .4] and [.6, 1.1], clipped: [0, 0, .4,
    .5, .6, 1, 1]; densities at the left edges 1.5, 1.5, 1.5, 1.5, .5, .5;
    weights 0, .6, .15, .15, .2, 0 over their sum 1.1."""
    t = torch.tensor([[0.0, 0.5, 1.0]])
    w = torch.tensor([[0.75, 0.25]])
    td, wd = plain.max_dilate_weights(t, w, 0.1)
    torch.testing.assert_close(td, torch.tensor([[0.0, 0.0, 0.4, 0.5, 0.6, 1.0, 1.0]]))
    torch.testing.assert_close(wd, torch.tensor([[0.0, 6.0, 1.5, 1.5, 2.0, 0.0]]) / 11)
    tp, wp = m3.max_dilate(t, w, 0.1)
    torch.testing.assert_close(tp, td[:, 1:-1])
    torch.testing.assert_close(wp, wd[:, 1:-1])


def test_placement_matches_the_reference():
    g = torch.Generator().manual_seed(2)
    t = torch.sort(torch.rand(200, 65, generator=g), -1).values
    t[:, 0], t[:, -1] = 0.0, 1.0
    w = torch.rand(200, 64, generator=g) ** 3
    w = w / w.sum(-1, keepdim=True)
    for dil, n in ((None, 64), (0.0025 + 0.5 / 64, 64), (0.0025 + 0.5 / 4096, 32)):
        s, tm = m3.place_plain(t, w, dil, n, Mip360Spec())
        tr, wr = (t, w) if dil is None else plain.max_dilate_weights(t, w, dil)
        if dil is not None:
            tr, wr = tr[:, 1:-1], wr[:, 1:-1]
        logits = torch.where(tr[:, 1:] > tr[:, :-1], torch.log(wr), torch.full_like(wr, -np.inf))
        ref = plain.sample_intervals(tr, logits, n)
        # w / sum against softmax(log w): an ulp apart
        torch.testing.assert_close(s, ref, rtol=0, atol=1e-5)
        assert s.shape == (200, n + 1) and bool((s[:, 1:] >= s[:, :-1]).all())
        torch.testing.assert_close(tm, 1.0 / (s * np.float32(1e-6) + (1 - s) * np.float32(10.0)))


def test_basis_is_the_tessellated_icosahedron():
    b = basis()
    assert b.shape == (21, 3)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-12)
    dots = b @ b.T
    assert (dots[~np.eye(21, dtype=bool)] > -1 + 1e-6).all()  # no antipodes, no repeats
    assert (dots[~np.eye(21, dtype=bool)] < 1 - 1e-6).all()
    np.testing.assert_array_equal(b, plain.generate_basis())


def test_slab_layout_round_trips_and_swizzles():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(128, 192, generator=g).to(torch.bfloat16)
    s = m3.to_slabs(x)
    assert s.shape == (2, 3, 64, 64)
    assert torch.equal(m3.from_slabs(s, 128, 192), x)
    # row r's 16-byte chunk c lies at chunk c ^ (r & 7) of its 128-byte row
    r, c = 13, 2
    assert torch.equal(s[0, 1, r, ((c ^ (r & 7)) * 8):((c ^ (r & 7)) * 8 + 8)], x[r, 64 + c * 8:64 + c * 8 + 8])
    w = torch.randn(128, 512, generator=g)
    p = m3.pack_linear(w, 256)
    assert p.shape == (2, 2, 256, 64)
    n, k = 300, 70  # column block 1, row 44; slab 1, column 6
    nn, kk = n - 256, k - 64
    chunk = (kk // 8) ^ (nn & 7)
    assert p[1, 1, nn, chunk * 8 + kk % 8] == w[k, n].to(torch.bfloat16)


def test_traced_frame_counts_its_samples_in_its_spans(tmp_path):
    """While a profiler records, a frame adds rays x 64 a proposal round and
    rays x 32 to the program counters and marks its stages with the m360
    spans; off, it counts nothing."""
    from nerf_workspaces_explorer_tpu_torch.obs import profiler

    r, _ = _renderer(tmp_path)
    profiler.reset_counters()
    r.render_pose(_pose())
    assert not any(k.startswith("render.m360") for k in profiler.read_counters())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render_pose(_pose())
    counts = profiler.read_counters()
    profiler.reset_counters()
    assert counts["render.m360_prop_samples"] == H * W * 128
    assert counts["render.m360_nerf_samples"] == H * W * 32
    names = {e.name for e in prof.events()}
    for name in ("m360.placement", "m360.proposal", "m360.nerf", "m360.encode", "m360.composite", "renderer.frame"):
        assert name in names, name
