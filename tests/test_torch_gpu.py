"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips without a CUDA card. This file imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import os

import pytest
import torch

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint, params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
BF16_ATOL = 5e-3  # bf16 weights and activations, summed in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_params(device):
    tree, _, _ = load_checkpoint(CKPT)
    return {
        k: fr.prepare_kernel_params(params_from_numpy(tree[k], device, torch.bfloat16), NerfMLPSpec())
        for k in ("coarse", "fine")
    }


def _inputs(device, n_rays, n_samples, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    o = torch.randn(n_rays, 3, generator=g) * 0.5
    d = torch.randn(n_rays, 3, generator=g)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    o_ph, d_ph = fr.ray_phase_vectors(o, d)
    venc = fr.encode_viewdirs_kernel_order(d / d.norm(dim=-1, keepdim=True))
    dists = fr._dists_from_z(z, d.norm(dim=-1)[None])
    return [t.to(device) for t in (o_ph, d_ph, z, dists, venc)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(4096, 64), (1000, 10)], ids=["aligned", "ragged"])
@pytest.mark.parametrize("density_only", [True, False], ids=["density", "full"])
def test_render_kernel_matches_plain(cuda, n_rays, n_samples, density_only):
    kp = _kernel_params(cuda)["coarse" if density_only else "fine"]
    o_ph, d_ph, z, dists, venc = _inputs(cuda, n_rays, n_samples)
    venc = None if density_only else venc
    before = dict(fr.LAUNCHES)
    out = fr.nerf_render(kp, o_ph, d_ph, z, dists, venc, density_only=density_only, early_stop_eps=0.0)
    torch.cuda.synchronize()
    mode = "density_only" if density_only else "full"
    assert fr.LAUNCHES[mode] == before[mode] + 1
    ref = fr.nerf_render_plain(kp, o_ph, d_ph, z, dists, venc, density_only=density_only)
    rows = slice(None) if density_only else slice(0, 5)
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    # Depth (row 3) sums weights times z up to 6: the bf16 bound scaled by far.
    atol = torch.full((out.shape[0], 1), BF16_ATOL, device=cuda)
    if not density_only:
        atol[3] = 6 * BF16_ATOL
    assert ((out[rows] - ref[rows]).abs() <= atol[rows]).all(), (out[rows] - ref[rows]).abs().amax(1)


@pytest.mark.gpu
def test_render_kernel_early_stop_is_exact_up_to_eps(cuda):
    kp = _kernel_params(cuda)["fine"]
    o_ph, d_ph, z, dists, venc = _inputs(cuda, 4096, 192, seed=1)
    live = torch.zeros(1, dtype=torch.int32, device=cuda)
    fast = fr.nerf_render(kp, o_ph, d_ph, z, dists, venc, early_stop_eps=1e-3, live_groups=live)
    exact = fr.nerf_render(kp, o_ph, d_ph, z, dists, venc, early_stop_eps=0.0)
    torch.cuda.synchronize()
    assert 0 < int(live) <= (4096 // 32) * (192 // 4)
    assert (fast[0:3] - exact[0:3]).abs().max() <= 1e-3 + 1e-5
    assert (fast[4] - exact[4]).abs().max() <= 1e-3 + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples,n_importance", [(76_800, 64, 128), (1000, 16, 16)])
def test_importance_kernel_matches_plain(cuda, n_rays, n_samples, n_importance):
    g = torch.Generator(device="cpu").manual_seed(2)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    centre = torch.rand(1, n_rays, generator=g) * 4 + 1
    w = torch.exp(-0.5 * ((z - centre) / 0.4) ** 2) + 1e-4
    w[:, 0] = 0.0
    z, w = z.to(cuda), w.to(cuda)
    before = im.LAUNCHES["importance_merge"]
    out = im.importance_merge(w, z, n_importance)
    torch.cuda.synchronize()
    assert im.LAUNCHES["importance_merge"] == before + 1
    ref = im.importance_merge_plain(w, z, n_importance)
    err = (out - ref).abs()
    # Equal up to the fp32 summation order of the CDF: flips to a neighbouring
    # interval on < 0.5% of depths, each within one coarse bin, outside merged
    # rows -3 and -2, where the u = 1 quantile may sit at either end of the
    # last bin; see tests/test_torch_importance_merge.py::assert_merge_close.
    rows = torch.ones(out.shape[0], dtype=torch.bool, device=cuda)
    rows[-3:-1] = False
    assert float((err[rows] > 1e-4).float().mean()) < 5e-3
    assert float(err.max()) <= float(torch.diff(z, dim=0).max()) + 1e-4
    assert (torch.diff(out, dim=0) >= 0).all()


def _uniform_inputs(n_samples, n_rays):
    z = torch.linspace(0.5, 8.0, n_samples)[:, None].expand(n_samples, n_rays).contiguous()
    return torch.ones(n_samples, n_rays), z


def _tied_inputs(n_samples, n_rays):
    """Exact CDF ties at u = 0.5 and u = 1 (see
    tests/test_torch_importance_merge.py::_tied_inputs)."""
    g = torch.Generator(device="cpu").manual_seed(3)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    a = torch.randint(1, n_samples - 3, (n_rays,), generator=g)
    b = a + 2 + (torch.rand(n_rays, generator=g) * (n_samples - 3 - a)).long()
    w = torch.zeros(n_samples, n_rays)
    w[a, torch.arange(n_rays)] = 2.0**20
    w[b, torch.arange(n_rays)] = 2.0**20
    return w, z


@pytest.mark.gpu
@pytest.mark.parametrize("inputs,n_samples,n_importance", [("uniform", 32, 64), ("ties", 16, 5)])
def test_importance_kernel_exact_cases(cuda, inputs, n_samples, n_importance):
    """Where no CDF edge is left to rounding (a strictly increasing CDF, or
    exact ties), the kernel equals the plain version on the CPU, the one the
    CPU tests hold against the JAX package, to fp32 rounding of the depths."""
    w, z = (_uniform_inputs if inputs == "uniform" else _tied_inputs)(n_samples, 1000)
    ref = im.importance_merge_plain(w, z, n_importance)
    out = im.importance_merge(w.to(cuda), z.to(cuda), n_importance).cpu()
    assert (out - ref).abs().max() <= 1e-5


@pytest.mark.gpu
def test_kernels_reject_bad_inputs(cuda):
    kp = _kernel_params(cuda)["fine"]
    o_ph, d_ph, z, dists, venc = _inputs(cuda, 64, 8)
    with pytest.raises(ValueError, match="venc"):
        fr.nerf_render(kp, o_ph, d_ph, z, dists, None)
    with pytest.raises(ValueError, match="contiguous float32"):
        fr.nerf_render(kp, o_ph, d_ph, z.double(), dists, venc)
    with pytest.raises(ValueError, match="3..256"):
        im.importance_merge(torch.zeros(300, 4, device=cuda), torch.zeros(300, 4, device=cuda), 4)


def _field_setup(device, n, seed=0, skips=(4,)):
    from nerf_workspaces_explorer_tpu_torch.models.mlp import init_nerf_params
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    g = torch.Generator(device="cpu").manual_seed(seed)
    spec = NerfMLPSpec(skips=skips)
    params = params_from_numpy(init_nerf_params(g, spec), device)
    inputs, meta = ff.build_kernel_inputs(params, spec)
    pts = (torch.randn(3, n, generator=g) * 2.0).to(device)
    views = torch.randn(3, n, generator=g)
    views = (views / views.norm(dim=0, keepdim=True)).to(device)
    g_raw = torch.zeros(8, n)
    g_raw[:4] = torch.randn(4, n, generator=g) * 1e-3
    return ff, inputs, meta, pts, views, g_raw.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 5000], ids=["aligned", "ragged"])
@pytest.mark.parametrize("skips", [(4,), ()], ids=["skip", "no-skip"])
def test_field_kernels_match_plain(cuda, n, skips):
    """K4 within 1e-3 and every K5 gradient within rel 5e-2 of the plain
    versions: the same bf16 algorithm, whose fp32 sums run in other orders,
    so a bf16 rounding of an activation or cotangent can land on the other
    side and carry through the 8 layers. On these inputs (random cotangents,
    whose sums cancel) the plain version itself moves by up to rel 2.2e-2
    when only its sums run in fp64 instead of fp32; the kernel read up to
    2.3e-2 on the H100."""
    ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, n, skips=skips)
    before = dict(ff.LAUNCHES)
    raw = ff.field_forward(inputs, meta, pts, views)
    kgrads = ff.field_backward(inputs, meta, pts, views, g_raw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["forward"] == before["forward"] + 1
    assert ff.LAUNCHES["backward"] == before["backward"] + 1
    assert ff.LAUNCHES["backward_kernels"] == before["backward_kernels"] + 4
    raw_ref = ff.field_forward_plain(inputs, meta, pts, views)
    assert torch.isfinite(raw).all()
    assert float((raw - raw_ref).abs().max()) <= 1e-3
    ref = ff.field_backward_plain(inputs, meta, pts, views, g_raw)
    assert list(kgrads) == list(ref)
    for name, a in kgrads.items():
        b = ref[name]
        assert a.shape == b.shape, name
        rel = float((a - b).abs().max() / (b.abs().max() + 1e-12))
        assert rel < 5e-2, (name, rel)


@pytest.mark.gpu
def test_field_backward_is_deterministic(cuda):
    ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, 20_000, seed=1)
    a = ff.field_backward(inputs, meta, pts, views, g_raw)
    b = ff.field_backward(inputs, meta, pts, views, g_raw)
    torch.cuda.synchronize()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.gpu
def test_fused_training_steps_on_the_card(cuda, tmp_path):
    """A few fused steps of the Trainer: finite losses, two K4 and two K5
    calls per step."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, logging=dataclasses.replace(
        cfg.logging, step_log_print=0, step_save_ckpt=0, step_render_test=0, step_render_train=0))
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=24, width=32, device=cuda)
    trainer = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=cuda,
                      save_dir=str(tmp_path), enable_tensorboard=False)
    assert trainer.field_impl == "fused"
    trainer.setup()
    before = dict(ff.LAUNCHES)
    losses = [float(trainer.step(i)["total_loss"]) for i in range(5)]
    assert all(map(lambda x: x == x and abs(x) < 1e3, losses))
    assert ff.LAUNCHES["forward"] - before["forward"] == 10
    assert ff.LAUNCHES["backward"] - before["backward"] == 10
    assert float(trainer.render_test_images(5)) == float(trainer.render_test_images(5))
