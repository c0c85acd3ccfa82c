"""The port's CUDA kernels against their plain versions, on the card: K1-K3
at every network shape the in-repo checkpoints need, K6 and K7, K4/K5, the
fine-pass ablation K8 and the int4 probe K9; and the paths that need the
card to show their contract (the strip-pipelined frame's bytes, the fast
preset at its served eps); mip-NeRF 360's K10-K13 at its published widths
and 512 rays of its path against the plain float32 reference.

Marked `gpu`: each test skips without a CUDA card. This file imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import hashlib
import os

import numpy as np
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
@pytest.mark.parametrize("n_rays,n_samples,n_importance", [
    (76_800, 64, 128), (1000, 16, 16),
    (4801, 64, 128),  # a ragged last tile
    (1000, 3, 16), (4096, 256, 128),  # the launcher's least and most coarse samples
    (2000, 256, 300),  # 556 output rows: more than one output tile, so row chunks
])
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


def _edge_inputs(n_samples, n_rays):
    """Every other ray all-zero (the uniform pdf of the +1e-5 guard), the
    rest all mass in the last interior weight: every quantile but u = 0
    lies in the last interval, and u = 1 clamps to the last bin."""
    g = torch.Generator(device="cpu").manual_seed(4)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    w = torch.zeros(n_samples, n_rays)
    w[-2, 1::2] = 50.0
    return w, z


@pytest.mark.gpu
@pytest.mark.parametrize("inputs,n_samples,n_importance,n_rays", [
    ("uniform", 32, 64, 1000), ("ties", 16, 5, 1000),
    ("ties", 64, 129, 76_800),  # at frame size; 128 intervals put u = 0.5 on the tie
    ("edge", 64, 128, 76_800),
])
def test_importance_kernel_exact_cases(cuda, inputs, n_samples, n_importance, n_rays):
    """Where no CDF edge is left to rounding (a strictly increasing CDF,
    exact ties, all-zero or last-bin rays), the kernel equals the plain
    version on the CPU, the one the CPU tests hold against the JAX package,
    to fp32 rounding of the depths, merged and importance-only."""
    make = {"uniform": _uniform_inputs, "ties": _tied_inputs, "edge": _edge_inputs}[inputs]
    w, z = make(n_samples, n_rays)
    for merge in (True, False):
        ref = im.importance_merge_plain(w, z, n_importance, merge=merge)
        out = im.importance_merge(w.to(cuda), z.to(cuda), n_importance, merge=merge).cpu()
        assert (out - ref).abs().max() <= 1e-5, merge


def _frame_inputs(device, n_rays=76_800, n_samples=64, seed=5):
    g = torch.Generator(device="cpu").manual_seed(seed)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    centre = torch.rand(1, n_rays, generator=g) * 4 + 1
    w = torch.exp(-0.5 * ((z - centre) / 0.4) ** 2) + 1e-4
    w[:, ::97] = 0.0
    return w.to(device), z.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays", [1, 31, 33, 4801])
@pytest.mark.parametrize("merge", [True, False], ids=["merge", "only"])
def test_importance_kernel_ragged_tiles(cuda, n_rays, merge):
    """A ray's placement does not depend on its tile: the first n_rays
    columns of a frame-size launch equal a launch on those rays alone, bit
    for bit, however ragged the last tile is (and with or without the
    16-byte copies, which need n_rays % 4 == 0)."""
    w, z = _frame_inputs(cuda)
    full = im.importance_merge(w, z, 128, merge=merge)
    part = im.importance_merge(w[:, :n_rays].contiguous(), z[:, :n_rays].contiguous(), 128, merge=merge)
    torch.cuda.synchronize()
    assert torch.equal(part, full[:, :n_rays])
    assert (torch.diff(part, dim=0) >= 0).all()


def _guarded_edge_inputs(n_samples, n_rays):
    """Quantiles just past bin edges under the `denom < 1e-5` guard: the
    interior weights alternate a per-ray weight (1 or 2**10) and 0, so the
    CDF climbs in equal steps separated by intervals of width ~1e-5 / sum;
    with (I - 1) a multiple of the steps the quantiles u = q / (I - 1) fall
    on step edges, on either side of a guarded interval by the summation
    order's rounding."""
    g = torch.Generator(device="cpu").manual_seed(7)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    w = torch.zeros(n_samples, n_rays)
    w[1:-1:2] = torch.where(torch.rand(n_rays, generator=g) < 0.5, 1.0, 2.0**10)
    return w, z


@pytest.mark.gpu
def test_importance_kernel_guarded_edges_are_a_permutation(cuda):
    """On the guarded-edge inputs each merged column is ascending and is,
    bit for bit, the sorted union of the coarse depths and the
    importance-only kernel's samples; both stay within the placement
    contract of the plain version."""
    n_samples, n_rays = 64, 76_800
    n_importance = 31 * 4 + 1  # 31 weighted bins: every 4th quantile on a step edge
    w, z = _guarded_edge_inputs(n_samples, n_rays)
    w, z = w.to(cuda), z.to(cuda)
    merged = im.importance_merge(w, z, n_importance)
    alone = im.importance_merge(w, z, n_importance, merge=False)
    torch.cuda.synchronize()
    assert (torch.diff(merged, dim=0) >= 0).all() and (torch.diff(alone, dim=0) >= 0).all()
    assert torch.equal(merged, torch.sort(torch.cat([z, alone]), dim=0).values)
    bin_w = float(torch.diff(z, dim=0).max())
    for out, ref in ((merged, im.importance_merge_plain(w, z, n_importance)),
                     (alone, im.importance_merge_plain(w, z, n_importance, merge=False))):
        assert float((out - ref).abs().max()) <= bin_w + 1e-4


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


def _field_setup(device, n, seed=0, skips=(4,), spec=None):
    from nerf_workspaces_explorer_tpu_torch.models.mlp import init_nerf_params
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    g = torch.Generator(device="cpu").manual_seed(seed)
    spec = spec or NerfMLPSpec(skips=skips)
    params = params_from_numpy(init_nerf_params(g, spec), device)
    inputs, meta = ff.build_kernel_inputs(params, spec)
    pts = (torch.randn(3, n, generator=g) * 2.0).to(device)
    views = torch.randn(3, n, generator=g)
    views = (views / views.norm(dim=0, keepdim=True)).to(device)
    g_raw = torch.zeros(8, n)
    g_raw[:4] = torch.randn(4, n, generator=g) * 1e-3
    return ff, inputs, meta, pts, views, g_raw.to(device)


# The distilled students (train/distill.py): the default 6x192@10f (its
# skip at layer 5, inside the trunk) and the opt-in 4x128@8f (the default
# skip lies past its depth), each through its own field library.
STUDENTS = {
    "student-6x192": dict(depth=6, width=192),
    "student-4x128": dict(depth=4, width=128, input_ch=51),
}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 5000, 1, 127, 129, 4097],
                         ids=["aligned", "ragged", "n1", "n127", "n129", "n4097"])
@pytest.mark.parametrize("skips", [(4,), (), "proposal", *STUDENTS],
                         ids=["skip", "no-skip", "proposal-2x64", *STUDENTS])
def test_field_kernels_match_plain(cuda, n, skips):
    """K4 within 1e-3 and every K5 gradient within rel 5e-2 of the plain
    versions: the same bf16 algorithm, whose fp32 sums run in other orders,
    so a bf16 rounding of an activation or cotangent can land on the other
    side and carry through the 8 layers. On these inputs (random cotangents,
    whose sums cancel) the plain version itself moves by up to rel 2.2e-2
    when only its sums run in fp64 instead of fp32; the kernel read up to
    2.3e-2 on the H100. "proposal" is the 2x64@6f/2f net of
    `render/proposal.py` (no skip), the students those of `STUDENTS`, each
    through its own library."""
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    if skips == "proposal":
        ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, n, spec=proposal_spec(6))
    elif skips in STUDENTS:
        ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, n, spec=NerfMLPSpec(**STUDENTS[skips]))
    else:
        ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, n, skips=skips)
    before = dict(ff.LAUNCHES)
    raw = ff.field_forward(inputs, meta, pts, views)
    kgrads = ff.field_backward(inputs, meta, pts, views, g_raw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["forward"] == before["forward"] + 1
    assert ff.LAUNCHES["backward"] == before["backward"] + 1
    assert ff.LAUNCHES["backward_kernels"] == before["backward_kernels"] + ff.BACKWARD_KERNELS
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
@pytest.mark.parametrize("n", [20_000, 129])
def test_field_backward_is_deterministic(cuda, n):
    """Two launches of K5 (and of K4) on the same inputs give the same bits:
    no atomics, sums in a fixed order."""
    ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, n, seed=1)
    a = ff.field_backward(inputs, meta, pts, views, g_raw)
    b = ff.field_backward(inputs, meta, pts, views, g_raw)
    fa = ff.field_forward(inputs, meta, pts, views)
    fb = ff.field_forward(inputs, meta, pts, views)
    torch.cuda.synchronize()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert torch.equal(fa, fb)


@pytest.mark.gpu
def test_proposal_field_backward_is_deterministic(cuda):
    """The 2x64 proposal net's K5 and K4 give the same bits twice."""
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, 65_536, seed=2, spec=proposal_spec(6))
    a = ff.field_backward(inputs, meta, pts, views, g_raw)
    b = ff.field_backward(inputs, meta, pts, views, g_raw)
    fa = ff.field_forward(inputs, meta, pts, views)
    fb = ff.field_forward(inputs, meta, pts, views)
    torch.cuda.synchronize()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert torch.equal(fa, fb)


@pytest.mark.gpu
@pytest.mark.parametrize("student", STUDENTS)
def test_student_field_backward_is_deterministic(cuda, student):
    """Each student's K5 and K4 give the same bits twice, at a distillation
    step's 196,608 fine points."""
    ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, 196_608, seed=4, spec=NerfMLPSpec(**STUDENTS[student]))
    a = ff.field_backward(inputs, meta, pts, views, g_raw)
    b = ff.field_backward(inputs, meta, pts, views, g_raw)
    fa = ff.field_forward(inputs, meta, pts, views)
    fb = ff.field_forward(inputs, meta, pts, views)
    torch.cuda.synchronize()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert torch.equal(fa, fb)


# K5's dW and db at every built field shape, recorded on the card by
# `scripts/record_field_bits.py` from fixed seeded inputs at two ragged point
# counts (a ragged last 128-point tile; one past 65,536): a change that
# moves the same bytes by other means keeps every bit. Each buffer is
# recorded as the SHA-256 digest of its raw float32 bytes, with a few
# sampled values to read when it differs.
FIELD_BITS = os.path.join(ROOT, "tests", "field_backward_bits.npz")
FIELD_BIT_SPECS = {"stock-8x256": {}, **STUDENTS, "proposal-2x64": "proposal"}
FIELD_BIT_CASES = [(shape, n) for shape in FIELD_BIT_SPECS for n in (1000, 65_573)]
FIELD_BIT_SAMPLES = 16


def field_bits_key(shape, n):
    return f"{shape}__n{n}"


def field_bits_case(device, shape, n):
    """(dW, db) of one K5 call on seeded inputs, flat float32 numpy arrays in
    the kernel's order."""
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    kw = FIELD_BIT_SPECS[shape]
    spec = proposal_spec(6) if kw == "proposal" else NerfMLPSpec(**kw)
    ff, inputs, meta, pts, views, g_raw = _field_setup(device, n, seed=7, spec=spec)
    grads, n_dw = ff._field_backward_flat(ff.pack_field_stream(inputs, meta), meta, pts, views, g_raw)
    torch.cuda.synchronize()
    out = grads.cpu().numpy()
    return out[:n_dw], out[n_dw:]


def field_bits_record(key, dw, db):
    """The `.npz` entries of one case: per buffer its size, digest, and
    FIELD_BIT_SAMPLES values at evenly spaced indices."""
    rec = {}
    for part, a in (("dw", dw), ("db", db)):
        idx = np.linspace(0, a.size - 1, FIELD_BIT_SAMPLES).astype(np.int64)
        rec[f"{key}__{part}_size"] = np.int64(a.size)
        rec[f"{key}__{part}_sha256"] = np.array(hashlib.sha256(a.tobytes()).hexdigest())
        rec[f"{key}__{part}_idx"] = idx
        rec[f"{key}__{part}_val"] = a[idx]
    return rec


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n", FIELD_BIT_CASES, ids=[field_bits_key(*c) for c in FIELD_BIT_CASES])
def test_field_backward_bit_equal_to_recorded(cuda, shape, n):
    """K5 at every built shape gives the recorded dW and db bit for bit."""
    key = field_bits_key(shape, n)
    got = field_bits_record(key, *field_bits_case(cuda, shape, n))
    with np.load(FIELD_BITS) as recorded:
        for part in ("dw", "db"):
            k = f"{key}__{part}"
            assert int(recorded[k + "_size"]) == int(got[k + "_size"]), part
            assert str(recorded[k + "_sha256"]) == str(got[k + "_sha256"]), (
                part, recorded[k + "_val"].tolist(), got[k + "_val"].tolist())


@pytest.mark.gpu
def test_field_kernels_refuse_unbuilt_shapes(cuda):
    """A net whose (width, frequencies) has no library raises, forward and
    backward: 4x128 at the stock 10 frequencies is not the 4x128@8f
    student."""
    ff, inputs, meta, pts, views, g_raw = _field_setup(cuda, 256, spec=NerfMLPSpec(depth=4, width=128))
    with pytest.raises(ValueError, match="built for"):
        ff.field_forward(inputs, meta, pts, views)
    with pytest.raises(ValueError, match="built for"):
        ff.field_backward(inputs, meta, pts, views, g_raw)


@pytest.mark.gpu
def test_field_kernels_on_a_second_card(cuda):
    """The field kernels opt into their shared memory on each device: a
    launch on the second card after one on the first runs and matches."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    outs = []
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        with torch.cuda.device(dev):
            ff, inputs, meta, pts, views, g_raw = _field_setup(dev, 4096, seed=3)
            outs.append((ff.field_forward(inputs, meta, pts, views).cpu(),
                         {k: v.cpu() for k, v in ff.field_backward(inputs, meta, pts, views, g_raw).items()}))
            torch.cuda.synchronize(dev)
    assert torch.equal(outs[0][0], outs[1][0])
    for name in outs[0][1]:
        assert torch.equal(outs[0][1][name], outs[1][1][name]), name


@pytest.mark.gpu
def test_training_step_makes_no_host_sync(cuda, tmp_path):
    """After one warm step, a fused training step (sampling, render, loss,
    backward through K4/K5, Adam) makes no synchronizing call and no
    host-to-device copy, so a CUDA graph can hold it: run under
    torch.cuda.set_sync_debug_mode("error")."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer
    from nerf_workspaces_explorer_tpu_torch.train.step import train_step

    cfg = load_config(office_name="tokyo")
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=24, width=32, device=cuda)
    tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=cuda, save_dir=str(tmp_path),
                 enable_tensorboard=False)
    tr.setup()
    args = (tr.rays_train, tr._train_rgbs)
    state, _ = train_step(tr.state, *args, tr._draws(0), tr._settings, tr._spec, tr._schedule)
    draws = tr._draws(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(state, *args, draws, tr._settings, tr._spec, tr._schedule)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_graph_replay_equals_eager_steps(cuda, tmp_path):
    """Trainer(steps_per_call=4) on the card: the first K-step call runs
    its steps eagerly and captures a CUDA graph, the next two replay it;
    the 12 losses equal K = 1's eager steps to 1e-6 and the parameters
    after them agree; a profiler trace of the replays shows K4 and K5's
    kernels twice a step, and the wrappers' counters do not move."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import device_kernel_counts
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, logging=dataclasses.replace(
        cfg.logging, step_log_print=0, step_save_ckpt=0, step_render_test=0, step_render_train=0))
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=24, width=32, device=cuda)

    def trainer(name, k):
        tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=cuda,
                     save_dir=str(tmp_path / name), enable_tensorboard=False, steps_per_call=k)
        tr.setup()
        return tr

    eager = trainer("eager", 1)
    losses = [float(eager.step(i)["total_loss"]) for i in range(12)]
    graphed = trainer("graphed", 4)
    got = graphed.step_many(0)["total_loss_steps"].tolist()
    assert graphed.graph_captured
    before = dict(ff.LAUNCHES)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got += graphed.step_many(4)["total_loss_steps"].tolist()
        got += graphed.step_many(8)["total_loss_steps"].tolist()
    ran = device_kernel_counts(prof)
    assert ff.LAUNCHES == before
    assert ran.get("field_fwd_kernel") == 16 and ran.get("field_bwd_chain_kernel") == 16, ran
    assert max(abs(a - b) for a, b in zip(got, losses)) <= 1e-6, (got, losses)
    assert graphed.state.step == 12
    for a, b in zip(tree_leaves(eager.params), tree_leaves(graphed.params)):
        assert float((a - b).abs().max()) <= 1e-6


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


def _tiny_room_trainer(device, tmp_path, name, steps_per_call=1, **kwargs):
    """A Trainer on a small synthetic scene with the stock config and no
    cadence action."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, logging=dataclasses.replace(
        cfg.logging, step_log_print=0, step_save_ckpt=0, step_render_test=0, step_render_train=0))
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=24, width=32, device=device)
    tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=device,
                 save_dir=str(tmp_path / name), enable_tensorboard=False, steps_per_call=steps_per_call,
                 **kwargs)
    tr.setup()
    return tr


@pytest.mark.gpu
@pytest.mark.parametrize("merge_coarse", [True, False], ids=["proposal", "proposal-fast-preset"])
def test_proposal_training_eager_and_graphed(cuda, tmp_path, merge_coarse):
    """Trainer(use_proposal=True) on the card: each eager step calls K4 and
    K5 once through the 2x64 proposal library and once through the stock
    one; 8 steps at steps_per_call=4 (the first call captures a CUDA graph,
    the second replays it) give the eager losses to 1e-6; the eval render
    goes through the proposal pass."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    prop, stock = _build.field_library(64, 6, 2), _build.field_library(256, 10, 4)
    eager = _tiny_room_trainer(cuda, tmp_path, "eager", use_proposal=True, merge_coarse=merge_coarse)
    assert sorted(eager.params) == ["fine", "proposal"]
    before = {k: dict(v) for k, v in ff.SHAPE_LAUNCHES.items()}
    losses = [float(eager.step(i)["total_loss"]) for i in range(8)]
    for lib in (prop, stock):
        for key in ("forward", "backward"):
            assert ff.SHAPE_LAUNCHES[lib][key] - before[lib][key] == 8, (lib, key)
    graphed = _tiny_room_trainer(cuda, tmp_path, "graphed", 4, use_proposal=True, merge_coarse=merge_coarse)
    got = graphed.step_many(0)["total_loss_steps"].tolist() + graphed.step_many(4)["total_loss_steps"].tolist()
    assert graphed.graph_captured
    assert max(abs(a - b) for a, b in zip(got, losses)) <= 1e-6, (got, losses)
    assert all(abs(x) < 1e9 for x in losses)
    psnr = eager.render_test_images(8)
    assert psnr == psnr


@pytest.mark.gpu
def test_proposal_training_step_makes_no_host_sync(cuda, tmp_path):
    """The proposal step (the interlevel loss included) makes no
    synchronizing call after a warm step, as the stock step does."""
    from nerf_workspaces_explorer_tpu_torch.train.step import train_step

    tr = _tiny_room_trainer(cuda, tmp_path, "sync", use_proposal=True, merge_coarse=False)
    args = (tr.rays_train, tr._train_rgbs)
    state, _ = train_step(tr.state, *args, tr._draws(0), tr._settings, tr._spec, tr._schedule)
    draws = tr._draws(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(state, *args, draws, tr._settings, tr._spec, tr._schedule)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# The slice-3 shapes: the proposal net (2x64, F=6, density-only), the two
# turbo students (4x128@8f, 6x192@10f) and the 8x256 nets, in every mode.
NETS = {
    "proposal-64f6": ("room_proposal.turbo.npz", "proposal"),
    "student-128f8": ("synth_proposal.turbo.npz", "fine"),
    "student-192f10": ("room_proposal.turbo.npz", "fine"),
    "fine-256f10": ("synth_hier.npz", "fine"),
}
MODES = ("bf16", "int8-trunk", "int8")


def _net_kernel_params(device, net, mode):
    from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_trunk, spec_from_net_params

    path, key = NETS[net]
    tree, _, _ = load_checkpoint(os.path.join(ROOT, "assets", "bench", path))
    params = params_from_numpy(tree[key], device)
    spec = spec_from_net_params(params)
    quant = None if mode == "bf16" else calibrate_trunk(params, spec, heads=mode == "int8")
    return fr.prepare_kernel_params(params, spec, quant=quant)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "net,density_only",
    [(n, True) for n in NETS] + [(n, False) for n in NETS if n != "proposal-64f6"],
    ids=lambda x: x if isinstance(x, str) else ("density" if x else "full"),
)
def test_render_kernel_shapes_and_modes_match_plain(cuda, net, mode, density_only):
    """K1/K3 at the proposal and student widths and K7 (int8-trunk, int8)
    against the plain version at eps 0: rgb, acc and weights within 5e-3
    (int8: integer trunks, equal when the fp32 encodings round alike). The
    proposal net runs density-only."""
    kp = _net_kernel_params(cuda, net, mode)
    o, d = torch.randn(2, 2048, 3, generator=torch.Generator().manual_seed(4))
    o = o * 0.5
    z = torch.sort(torch.rand(48, 2048, generator=torch.Generator().manual_seed(5)) * 5.9 + 0.1, dim=0).values
    o_ph, d_ph = fr.ray_phase_vectors(o, d, kp.pts_freqs)
    venc = None if density_only else fr.encode_viewdirs_kernel_order(d / d.norm(dim=-1, keepdim=True)).to(cuda)
    dists = fr._dists_from_z(z, d.norm(dim=-1)[None])
    args = [t.to(cuda) for t in (o_ph, d_ph, z, dists)]
    key = ("density_only" if density_only else "full") + {"bf16": "", "int8-trunk": "_int8_trunk", "int8": "_int8"}[mode]
    before = fr.LAUNCHES[key]
    out = fr.nerf_render(kp, *args, venc, density_only=density_only, early_stop_eps=0.0)
    torch.cuda.synchronize()
    assert fr.LAUNCHES[key] == before + 1
    ref = fr.nerf_render_plain(kp, *args, venc, density_only=density_only)
    assert torch.isfinite(out).all()
    rows = slice(None) if density_only else [0, 1, 2, 4]
    err = (out[rows] - ref[rows]).abs()
    assert float(err.max()) <= BF16_ATOL, float(err.max())


# The render kernel's outputs at every (net, mode, pass) of the grid above,
# recorded on the card by `scripts/record_render_bits.py` from fixed seeded
# inputs: a schedule change that keeps each product's order of accumulation
# keeps every bit. A change that rightly moves the arithmetic records anew.
RENDER_BITS = os.path.join(ROOT, "tests", "render_kernel_bits.npz")
BIT_RAYS, BIT_SAMPLES = 300, 18  # a ragged last block of rays and a ragged last 4-sample step
BIT_CASES = [(n, m, True) for n in NETS for m in MODES] + [
    (n, m, False) for n in NETS if n != "proposal-64f6" for m in MODES]


def render_bits_key(net, mode, density_only):
    return f"{net}__{mode}__{'density' if density_only else 'full'}"


def render_bits_case(device, net, mode, density_only):
    """One launch of the kernel at eps 0 on BIT_RAYS x BIT_SAMPLES seeded
    inputs, synchronized; [S, R] weights or [8, R] maps."""
    kp = _net_kernel_params(device, net, mode)
    g = torch.Generator().manual_seed(20)
    o = torch.randn(BIT_RAYS, 3, generator=g) * 0.5
    d = torch.randn(BIT_RAYS, 3, generator=g)
    z = torch.sort(torch.rand(BIT_SAMPLES, BIT_RAYS, generator=g) * 5.9 + 0.1, dim=0).values
    o_ph, d_ph = fr.ray_phase_vectors(o, d, kp.pts_freqs)
    venc = None if density_only else fr.encode_viewdirs_kernel_order(d / d.norm(dim=-1, keepdim=True)).to(device)
    dists = fr._dists_from_z(z, d.norm(dim=-1)[None])
    args = [t.to(device) for t in (o_ph, d_ph, z, dists)]
    out = fr.nerf_render(kp, *args, venc, density_only=density_only, early_stop_eps=0.0)
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("net,mode,density_only", BIT_CASES,
                         ids=[render_bits_key(*c).replace("__", "-") for c in BIT_CASES])
def test_render_kernel_bit_equal_to_recorded(cuda, net, mode, density_only):
    """K1/K3/K7 at every served shape, mode and pass give the recorded
    outputs bit for bit (NaN and signed zeros included)."""
    with np.load(RENDER_BITS) as recorded:
        want = recorded[render_bits_key(net, mode, density_only)]
    out = render_bits_case(cuda, net, mode, density_only).cpu().numpy()
    assert out.shape == want.shape and out.dtype == want.dtype == np.float32
    differ = out.view(np.uint32) != want.view(np.uint32)
    assert not differ.any(), f"{int(differ.sum())} of {differ.size} outputs differ"


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples,n_importance,n_rays", [
    (64, 48, 4800), (64, 128, 76_800), (16, 5, 1000),
    (64, 48, 4801), (3, 4, 500), (256, 300, 700),  # ragged tile; least and most S; row chunks
])
def test_importance_only_kernel_matches_plain(cuda, n_samples, n_importance, n_rays):
    """K6 (merge=False) against its plain version: ascending, boundary flips
    on < 0.5% of samples, each within one coarse bin, off the last row: there
    the u = 1 quantile may sit at either end of the last bin when the CDF's
    last entry rounds differently (the running sum against torch.cumsum),
    as on merged rows -3/-2 of K2, so it moves by at most its ray's last
    bin."""
    g = torch.Generator(device="cpu").manual_seed(6)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    centre = torch.rand(1, n_rays, generator=g) * 4 + 1
    w = torch.exp(-0.5 * ((z - centre) / 0.4) ** 2) + 1e-4
    z, w = z.to(cuda), w.to(cuda)
    before = im.LAUNCHES["importance_only"]
    out = im.importance_merge(w, z, n_importance, merge=False)
    torch.cuda.synchronize()
    assert im.LAUNCHES["importance_only"] == before + 1
    ref = im.importance_merge_plain(w, z, n_importance, merge=False)
    assert out.shape == ref.shape == (n_importance, n_rays)
    assert (torch.diff(out, dim=0) >= 0).all()
    err = (out - ref).abs()
    assert float((err[:-1] > 1e-4).float().mean()) < 5e-3
    assert float(err[:-1].max()) <= float(torch.diff(z, dim=0).max()) + 1e-4
    mid = 0.5 * (z[1:] + z[:-1])
    assert float((err[-1] - (mid[-1] - mid[-2])).max()) <= 1e-4


@pytest.mark.gpu
def test_turbo_int8_frame_launches(cuda):
    """One turbo int8 frame through the renderer: one proposal density pass,
    one importance-only placement, one student full pass, all int8. After
    the warm-up the frame is a replay of the frame graph, which calls no
    wrapper: a profiler trace counts its kernels, `render_kernel<W, F,
    MODE, DENSITY_ONLY>` with MODE 2 (int8)."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import kernel_name

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, depth_range=(0.1, 8.0)))
    r = NeRFRenderer("tokyo", os.path.join(ROOT, "assets", "bench", "room_proposal.npz"), config=cfg,
                     precision="int8", preset="turbo", device=cuda)
    r.initialize_models()
    r.warmup()
    counters = (fr.LAUNCHES, im.LAUNCHES)
    before = [dict(c) for c in counters]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        frame = r.render_pose_uint8(torch.eye(4).numpy())
        torch.cuda.synchronize()
    assert [dict(c) for c in counters] == before
    ran = {}
    for e in prof.key_averages():
        name = kernel_name(e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name in ("render_kernel", "importance_merge_kernel"):
            key = e.key.split("render_kernel<")[1].split(">")[0] if name == "render_kernel" else name
            ran[key] = ran.get(key, 0) + e.count
    assert ran == {"64, 6, 2, true": 1, "192, 10, 2, false": 1, "importance_merge_kernel": 1}, ran
    assert frame.shape == (240, 320, 3) and frame.dtype == torch.uint8


@pytest.mark.gpu
def test_fast_preset_frame_at_served_eps(cuda):
    """synth_hier at the fast preset (importance-only placement, 8x256 nets):
    the frame at the served early-stop eps against the eps-0 frame, on the
    office_geneve click where stopping the density pass of a whole 32-ray
    block at T <= 1e-3 moved the importance samples (SSIM 0.977 against
    parity). The renderer passes its eps to both passes; the density pass
    feeding importance-only placement stops a block only once its tail
    weights are below what the pdf's guard resolves (csrc/fused_render.cu),
    and the fine pass stays exact up to eps per ray. A plain stop of that
    pass at 1e-4 or 1e-3 fails both bounds on this click."""
    from nerf_workspaces_explorer_tpu_torch.app.workspace import OfficeGeneveWorkspace
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    init, coord = OfficeGeneveWorkspace(ckpt_path=CKPT, device=cuda).transform_relative_coordinates(
        0.4, 0.6, 30, -10)
    pose = poses_from_coordinates(init, [coord])[0]
    frames = []
    for eps in (1e-3, 0.0):
        r = NeRFRenderer("tokyo", CKPT, precision="fast", preset="fast", device=cuda, early_stop_eps=eps)
        r.initialize_models()
        frames.append(r.render_pose(pose))
    d = (frames[0] - frames[1]).abs()
    stats = (float(d.mean()), float((d > 1e-2).float().mean()), float(d.max()))
    assert stats[0] <= 1e-4 and stats[1] <= 1e-3, stats


def _student_int8(device):
    """The 4x128@8f student of the fine-pass ablation, int8 trunk and heads."""
    from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_trunk, spec_from_net_params

    tree, _, _ = load_checkpoint(os.path.join(ROOT, "assets", "bench", "synth_proposal.turbo.npz"))
    params = params_from_numpy(tree["fine"], device)
    spec = spec_from_net_params(params)
    return fr.prepare_kernel_params(params, spec, quant=calibrate_trunk(params, spec, heads=True))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "enc", "enc-direct", "enc-nobase", "enc-noconcat", "enc-postq", "enc-stack",
                                  "enc-duo", "heads", "epilogue", "enc+heads+epilogue"])
def test_ablation_kernel_matches_plain(cuda, mode):
    """K8, every mode, against its plain version on the card (4,096 rays x 48
    samples, sample groups of 16): the same fp32 chains, exact integer
    products and the same compositing order, so at least 99% of the rays
    agree to 1e-6 (relative to the largest sum where the sums are raw
    activations or accumulators: "heads", "epilogue") and every ray within
    2e-3 of the colours or 2e-2 of the raw scale."""
    from nerf_workspaces_explorer_tpu_torch.ops import fine_ablation as fa

    kp = _student_int8(cuda)
    g = torch.Generator().manual_seed(8)
    o, d = torch.randn(2, 4096, 3, generator=g)
    z = torch.sort(torch.rand(48, 4096, generator=g) * 5.9 + 0.1, dim=0).values
    o_ph, d_ph = fr.ray_phase_vectors(o * 0.5, d, kp.pts_freqs)
    venc = fr.encode_viewdirs_kernel_order(d / d.norm(dim=-1, keepdim=True))
    args = [t.to(cuda) for t in (o_ph, d_ph, z, fr._dists_from_z(z, d.norm(dim=-1)[None]), venc)]
    ablate = frozenset() if mode == "full" else frozenset(mode.split("+"))
    before = fa.LAUNCHES[mode]
    out = fa.run_ablation(kp, *args, ablate, samples_per_step=16)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[mode] == before + 1
    ref = fa.run_ablation_plain(kp, *args, ablate, samples_per_step=16)
    assert out.shape == (8, 4096) and torch.isfinite(out).all()
    assert not out[[3, 4, 6, 7]].any()
    raw = "heads" in ablate or "epilogue" in ablate
    scale = max(1.0, float(ref[0:3].abs().max())) if raw else 1.0
    err = (out[[0, 1, 2, 5]] - ref[[0, 1, 2, 5]]).abs() / scale
    assert float((err.amax(0) <= 1e-6).float().mean()) >= 0.99, float((err.amax(0) <= 1e-6).float().mean())
    assert float(err.max()) <= (2e-2 if raw else 2e-3), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["int4-operand", "int4x2-packed-bytes"])
def test_int4_kernel_matches_plain(cuda, packed):
    """K9: int4 widened to bf16 on wgmma against the plain leg and numpy at
    the probe's 128^3 (to 1e-6 relative: exact products, fp32 sums in
    another order) and at 256 x 384 x 128 (4 x 3 blocks); shapes the kernel
    does not take (M not a multiple of 64, N of 128, K other than 128)
    raise."""
    from nerf_workspaces_explorer_tpu_torch.ops import int4_probe as ip

    g = torch.Generator().manual_seed(9)
    for m, n, k in ((48, 128, 128), (128, 80, 128), (128, 128, 32)):
        w4 = torch.randint(-8, 8, (m, k), generator=g, dtype=torch.int8)
        a = ip.pack_int4_rows(w4) if packed else w4
        with pytest.raises(ValueError, match="multiple of 64"):
            ip.int4_matmul(a.to(cuda), torch.zeros(k, n, dtype=torch.bfloat16, device=cuda), packed=packed)
    for m, n, k in ((128, 128, 128), (256, 384, 128)):
        w4 = torch.randint(-8, 8, (m, k), generator=g, dtype=torch.int8)
        b = torch.randn(k, n, generator=g).to(torch.bfloat16)
        a = ip.pack_int4_rows(w4) if packed else w4
        key = "int4x2_packed" if packed else "int4_operand"
        before = ip.LAUNCHES[key]
        out = ip.int4_matmul(a.to(cuda), b.to(cuda), packed=packed)
        torch.cuda.synchronize()
        assert ip.LAUNCHES[key] == before + 1
        ref = w4.numpy().astype("float32") @ b.float().numpy()
        plain = ip.int4_matmul_plain(a.to(cuda), b.to(cuda), packed=packed)
        scale = float(abs(ref).max())
        assert float((out.cpu() - torch.from_numpy(ref)).abs().max()) / scale <= 1e-6
        assert float((out - plain).abs().max()) / scale <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["reference", "fast"])
def test_strip_frame_equals_blocking_at_eps0(cuda, preset):
    """The strip-pipelined frame through the kernels at eps 0: byte-equal to
    the blocking frame (per-ray arithmetic), each strip one density pass,
    one placement and one fine pass. Reference: synth_hier in 6 strips of
    40 rows; fast: the room's proposal net on its stride-4 lattice."""
    import dataclasses

    import numpy as np

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    cfg = load_config(office_name="tokyo")
    if preset == "fast":
        cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, depth_range=(0.1, 8.0)))
        r = NeRFRenderer("tokyo", os.path.join(ROOT, "assets", "bench", "room_proposal.npz"), config=cfg,
                         precision="fast", preset="fast", use_proposal=True, early_stop_eps=0.0, device=cuda)
    else:
        r = NeRFRenderer("tokyo", CKPT, config=cfg, precision="fast", early_stop_eps=0.0, device=cuda)
    r.initialize_models()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, -0.5, 0.5]
    blocking = r.render_pose_uint8(pose).cpu().numpy()
    n = r._pick_n_strips()
    assert n == 6
    counters = (fr.LAUNCHES, im.LAUNCHES)
    before = [dict(c) for c in counters]
    piped = r.render_pose_uint8_pipelined(pose)
    delta = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
    assert sorted(delta.values()) == [n] * 3, delta
    assert piped.dtype == np.uint8 and piped.shape == blocking.shape
    np.testing.assert_array_equal(piped, blocking)


def _net_inputs(device, kp, n_rays, n_samples, seed, full=True):
    g = torch.Generator().manual_seed(seed)
    o, d = torch.randn(2, n_rays, 3, generator=g)
    z = torch.sort(torch.rand(n_samples, n_rays, generator=g) * 5.9 + 0.1, dim=0).values
    o_ph, d_ph = fr.ray_phase_vectors(o * 0.5, d, kp.pts_freqs)
    dists = fr._dists_from_z(z, d.norm(dim=-1)[None])
    venc = fr.encode_viewdirs_kernel_order(d / d.norm(dim=-1, keepdim=True)) if full else None
    return [None if t is None else t.to(device) for t in (o_ph, d_ph, z, dists, venc)]


def _assert_maps_close(out, ref, density_only):
    """rgb, acc (and T) within the bf16 bound, depth within it times the far
    plane (6); density weights within the bf16 bound."""
    assert out.shape == ref.shape and torch.isfinite(out).all()
    if density_only:
        assert float((out - ref).abs().max()) <= BF16_ATOL
        return
    err = (out[:6] - ref[:6]).abs().amax(1)
    assert float(err[[0, 1, 2, 4, 5]].max()) <= BF16_ATOL and float(err[3]) <= 6 * BF16_ATOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("density_only", [True, False], ids=["density", "full"])
def test_render_kernel_drains_its_weight_stream_at_a_first_step_stop(cuda, mode, density_only):
    """eps 1.0: every block stops after its first 4-sample step (T <= 1
    always), while the producer has issued the next step's first weight
    slabs (a step of the 8x256 net is 34-40 slabs, the ring 3). The maps
    equal the plain version on the first 4 samples, the density pass's
    later weights are 0, and a launch after it on the same stream is right."""
    kp = _net_kernel_params(cuda, "fine-256f10", mode)
    o_ph, d_ph, z, dists, venc = _net_inputs(cuda, kp, 1000, 48, seed=10, full=not density_only)
    live = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = fr.nerf_render(kp, o_ph, d_ph, z, dists, venc, density_only=density_only, early_stop_eps=1.0,
                         live_groups=live)
    after = fr.nerf_render(kp, o_ph, d_ph, z, dists, venc, density_only=density_only, early_stop_eps=0.0)
    torch.cuda.synchronize()
    assert int(live) == -(-1000 // fr.STEP_RAYS)
    first = fr.nerf_render_plain(kp, o_ph, d_ph, z[:4].contiguous(), dists[:4].contiguous(), venc,
                                 density_only=density_only)
    if density_only:
        _assert_maps_close(out[:4], first, True)
        assert not out[4:].any()
    else:
        _assert_maps_close(out, first, False)
    _assert_maps_close(after, fr.nerf_render_plain(kp, o_ph, d_ph, z, dists, venc, density_only=density_only),
                       density_only)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", ["student-128f8", "student-192f10", "fine-256f10"])
def test_render_kernel_full_pass_ragged_rays_and_samples(cuda, net, mode):
    """The full pass at every full-pass shape with R mod 32 != 0 and S mod 4
    != 0 (1,000 rays of 10 samples) against the plain version, at eps 0 and
    at 1e-3 (exact up to eps)."""
    kp = _net_kernel_params(cuda, net, mode)
    args = _net_inputs(cuda, kp, 1000, 10, seed=11)
    ref = fr.nerf_render_plain(kp, *args)
    out = fr.nerf_render(kp, *args, early_stop_eps=0.0)
    stopped = fr.nerf_render(kp, *args, early_stop_eps=1e-3)
    torch.cuda.synchronize()
    _assert_maps_close(out, ref, False)
    assert float((stopped[[0, 1, 2, 4]] - out[[0, 1, 2, 4]]).abs().max()) <= 1e-3 + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("density_only", [True, False], ids=["density", "full"])
def test_render_kernel_launches_are_bit_equal(cuda, mode, density_only):
    """Two launches on the same inputs at the served eps agree bit for bit,
    the evaluated steps included: the products sum in a fixed order."""
    kp = _net_kernel_params(cuda, "fine-256f10", mode)
    o_ph, d_ph, z, dists, venc = _net_inputs(cuda, kp, 4096, 64, seed=12, full=not density_only)
    outs, lives = [], []
    for _ in range(2):
        live = torch.zeros(1, dtype=torch.int32, device=cuda)
        outs.append(fr.nerf_render(kp, o_ph, d_ph, z, dists, venc, density_only=density_only, early_stop_eps=1e-3,
                                   live_groups=live))
        lives.append(live)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(lives[0], lives[1])


@pytest.mark.gpu
def test_distill_student_on_the_card_serves_a_turbo_sidecar(cuda, tmp_path):
    """A few distillation steps of the 6x192@10f student on the card (the
    teacher's views through K1-K3, K4/K5 through the student's library and
    the proposal net's), its sidecar written and served by the turbo
    renderer: a finite frame, one density pass, placement and fine pass."""
    from nerf_workspaces_explorer_tpu_torch.core.config import ExperimentConfig, FrameworkConfig, RenderingConfig
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import room_grid_poses
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer, settings_from_config, spec_from_config
    from nerf_workspaces_explorer_tpu_torch.ops import _build
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.train import distill as dist

    room = os.path.join(ROOT, "assets", "bench", "room_proposal.npz")
    teacher, _, meta = load_checkpoint(room)
    near, far = (float(x) for x in meta["depth_range"])
    cfg = FrameworkConfig(experiment=ExperimentConfig(image_width=32, image_height=24),
                          rendering=RenderingConfig(depth_range=(near, far)))
    settings = settings_from_config(cfg).for_eval()._replace(use_proposal=True)
    poses = room_grid_poses(grid=2)
    student = _build.field_library(192, 10, 4)
    before = {k: dict(v) for k, v in ff.SHAPE_LAUNCHES.items()}
    params, s_cfg, report = dist.distill_student(
        teacher, spec_from_config(cfg), settings, poses, height=24, width=32, near=near, far=far, steps=6,
        n_holdout=2, log_every=0, save_dir=str(tmp_path / "run"), device=cuda)
    assert ff.SHAPE_LAUNCHES[student]["forward"] - before[student]["forward"] == 6
    assert ff.SHAPE_LAUNCHES[student]["backward"] - before[student]["backward"] == 6
    assert sorted(params) == ["fine", "proposal"] and report["psnr_vs_teacher"] == report["psnr_vs_teacher"]
    ckpt = str(tmp_path / "room.npz")
    dist.save_turbo_checkpoint(dist.turbo_sidecar_path(ckpt), params, s_cfg, report=report, teacher=room, step=6)
    r = NeRFRenderer("tokyo", ckpt, config=cfg, precision="fast", preset="turbo", device=cuda)
    r.initialize_models()
    before = (dict(fr.LAUNCHES), dict(im.LAUNCHES))
    frame = r.render_pose(poses[0])  # eager, then the frame graph's capture: two wrapper calls each
    torch.cuda.synchronize()
    assert frame.shape == (24, 32, 3) and bool(torch.isfinite(frame).all())
    assert fr.LAUNCHES["density_only"] - before[0]["density_only"] == 2
    assert fr.LAUNCHES["full"] - before[0]["full"] == 2
    assert im.LAUNCHES["importance_only"] - before[1]["importance_only"] == 2


def _tk_explorer_on_the_card(cuda, tmp_path, monkeypatch):
    """The tkinter explorer (duck-typed toolkit, a root that queues as Tk's
    does) over Office Tokyo served from synth_hier at precision "fast"."""
    import importlib
    import sys
    import types

    from fake_toolkits import TkEvent, make_fake_tk  # tests/ is on the path under pytest
    from test_torch_gui import PPMPhoto, QueuedRoot

    from nerf_workspaces_explorer_tpu_torch.app import workspace as ws

    try:
        import tkinter  # noqa: F401
    except ImportError:  # a machine without Tk: gui_tk's module constants need the names alone
        stub = types.ModuleType("tkinter")
        vars(stub).update(vars(make_fake_tk()))
        monkeypatch.setitem(sys.modules, "tkinter", stub)
    gui_tk = importlib.import_module("nerf_workspaces_explorer_tpu_torch.app.gui_tk")
    fake_tk = make_fake_tk()
    fake_tk.PhotoImage = PPMPhoto
    monkeypatch.setattr(gui_tk, "tk", fake_tk)
    monkeypatch.setattr(gui_tk, "BTN_MAIN", {**gui_tk.BTN_MAIN, "relief": fake_tk.FLAT})
    monkeypatch.setattr(gui_tk, "BTN_CAMERA", {**gui_tk.BTN_CAMERA, "relief": fake_tk.FLAT})
    monkeypatch.setattr(ws, "ASSETS_DIR", str(tmp_path / "workspaces"))
    workspace = ws.OfficeTokyoWorkspace(ckpt_path=CKPT, precision="fast", device=cuda)
    root = QueuedRoot()
    landing = gui_tk.LandingPage(root, [workspace])
    gui_tk.WorkspaceExplorer(root, landing, workspace)
    plan = [w for w in root.find(lambda w: "<Button-1>" in w.bindings) if w.kwargs.get("image") is not None][-1]
    explorer = plan.bindings["<Button-1>"].__self__
    installed = []
    original = explorer._install_frame
    explorer._install_frame = lambda image: installed.append(image) or original(image)
    plan.bindings["<Button-1>"](TkEvent(300, 300))
    root.pump(lambda: len(installed) == 2)  # the preview, then the full frame
    explorer._install_frame = original
    return root, explorer, workspace


@pytest.mark.gpu
def test_tk_worker_frame_equals_main_thread_frame(cuda, tmp_path, monkeypatch):
    """A frame rendered on the Tk worker thread (its own current stream and
    device) is byte-equal to the same click rendered on this thread."""
    root, explorer, workspace = _tk_explorer_on_the_card(cuda, tmp_path, monkeypatch)
    np.testing.assert_array_equal(explorer.frame_shown, workspace.render_image(0.5, 0.5, 0, 0))
    explorer.state.turn_left()
    worker = explorer._request_render()
    worker.join(60)
    assert not worker.is_alive()
    while root.queue.qsize():
        root.queue.get()()
    np.testing.assert_array_equal(explorer.frame_shown, workspace.render_image(0.5, 0.5, -30, 0))


@pytest.mark.gpu
def test_tk_overlapping_requests_install_the_later_frame(cuda, tmp_path, monkeypatch):
    root, explorer, workspace = _tk_explorer_on_the_card(cuda, tmp_path, monkeypatch)
    workers = []
    for turn in (explorer.state.turn_left, explorer.state.turn_up, explorer.state.turn_right):
        turn()
        workers.append(explorer._request_render())
    for w in workers:
        w.join(60)
        assert not w.is_alive()
    installed = []
    original = explorer._install_frame
    explorer._install_frame = lambda image: installed.append(image) or original(image)
    while root.queue.qsize():
        root.queue.get()()
    assert installed and len(installed) <= 2  # the last request's preview and frame
    np.testing.assert_array_equal(installed[-1], workspace.render_image(0.5, 0.5, 0, 30))


@pytest.mark.gpu
def test_trainer_on_a_replica_sequence_on_the_card(cuda, tmp_path, monkeypatch):
    """Trainer(office) with no data: the Replica-layout room sequence
    (64x48 PNGs, every row filter, resized to 32x24) through K4/K5."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data import replica
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import render_room_ground_truth, room_scene, walkthrough_poses
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    n = 18
    poses = walkthrough_poses(n)
    rgb, depth = render_room_ground_truth(room_scene(), poses, 48, 64, device=cuda)
    replica.write_sequence(str(tmp_path / "office0" / "Sequence_1"),
                           np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                           np.clip(np.round(depth * 1000), 0, 65535).astype(np.uint16), poses,
                           filters=[i % 5 for i in range(n)])
    monkeypatch.setattr(replica, "DATASETS_PATH", str(tmp_path))
    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(
        cfg, experiment=dataclasses.replace(cfg.experiment, image_width=32, image_height=24),
        rendering=dataclasses.replace(cfg.rendering, depth_range=(0.1, 8.0)),
        logging=dataclasses.replace(cfg.logging, step_log_print=0, step_save_ckpt=0, step_render_test=0,
                                    step_render_train=0))
    trainer = Trainer("office_tokyo", cfg, save_dir=str(tmp_path / "run"), enable_tensorboard=False, device=cuda)
    assert trainer.field_impl == "fused" and trainer._train_data.rgb.shape == (4, 24, 32, 3)
    trainer.setup()
    before = dict(ff.LAUNCHES)
    losses = [float(trainer.step(i)["total_loss"]) for i in range(100)]
    assert ff.LAUNCHES["forward"] - before["forward"] == 200
    assert np.isfinite(losses).all() and np.mean(losses[-20:]) < np.mean(losses[:20])


def _mesh_frame(device, h=240, w=320):
    """A 320x240 frame of rays into synth_hier's scene."""
    from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays

    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.3, -0.2, 0.5])
    return create_rays(pose[None].to(device), h, w, w / 2.0, w / 2.0, (w - 1) / 2.0, (h - 1) / 2.0, 0.1,
                       6.0).reshape(h * w)


def _mesh_step_inputs(device, mesh, seed=0):
    """A stock-config data-parallel step's inputs on `mesh`: the state, its
    replicas, rays, colours and each shard's draws of 1,024 rays."""
    from nerf_workspaces_explorer_tpu_torch.parallel.sharding import tree_to
    from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings
    from nerf_workspaces_explorer_tpu_torch.train import step as tstep

    settings = RenderSettings(raw_noise_std=1.0, field_impl="fused")
    schedule = tstep.ExponentialDecay()
    state = tstep.init_train_state(NerfMLPSpec(), schedule, device, seed=seed)
    poses = torch.eye(4).repeat(2, 1, 1)
    poses[1, :3, 3] = torch.tensor([0.2, -0.1, 0.3])
    rays = create_rays(poses.to(device), 16, 16, 8.0, 8.0, 7.5, 7.5, 0.1, 6.0)
    rgbs = torch.rand((2, 256, 3), generator=torch.Generator().manual_seed(seed)).to(device)
    devices = mesh.distinct_devices
    gens = {d: torch.Generator(device=d) for d in devices}

    def draws(step):
        return tstep.draw_shards(gens, [seed * 100 + step * 10 + i for i in range(mesh.size)], step, 2, 256, 1024,
                                 settings, mesh)

    return (state, tstep.mesh_replicas(state, mesh), {d: tree_to(rays, d) for d in devices},
            {d: rgbs.to(d) for d in devices}, draws, settings, schedule)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_repeating_the_card_shards_like_one(cuda, k):
    """`shard_render`'s fused leg over a mesh repeating cuda:0 k times: each
    shard launches K1, K2 and K3 once, and the frame equals the unsharded
    one (76,800 / k rays are whole 32-ray blocks, so every block stops at
    the same sample)."""
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh, shard_render
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings

    kp = _kernel_params(cuda)
    rays = _mesh_frame(cuda)
    single = fr.render_rays_fused(kp, rays, RenderSettings(), early_stop_eps=1e-3)
    mesh = data_mesh(devices=[cuda] * k)
    before = (dict(fr.LAUNCHES), dict(im.LAUNCHES))
    out = shard_render(kp, rays, RenderSettings(), mesh, use_fused=True)["rgb_fine"]
    torch.cuda.synchronize()
    assert fr.LAUNCHES["density_only"] - before[0]["density_only"] == k
    assert fr.LAUNCHES["full"] - before[0]["full"] == k
    assert im.LAUNCHES["importance_merge"] - before[1]["importance_merge"] == k
    assert torch.equal(out, single)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_step_on_a_repeated_card(cuda, k):
    """A data-parallel step over cuda:0 k times through K4/K5: its gradient
    over k equals the single-device gradient of the shards' concatenated
    batch (same draws) to the fused field's rel 0.08, and each shard makes
    two K4 and two K5 calls; after the first step, a step makes no host
    sync (torch.cuda.set_sync_debug_mode("error"))."""
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderDraws
    from nerf_workspaces_explorer_tpu_torch.train import step as tstep

    mesh = data_mesh(devices=[cuda] * k)
    state, replicas, rays, rgbs, draws, settings, schedule = _mesh_step_inputs(cuda, mesh)
    d = draws(0)
    grads, _ = tstep.data_parallel_grads(replicas, rays, rgbs, d, settings, NerfMLPSpec(), mesh)
    joined = tstep.StepDraws(d[0].img_idx, torch.cat([x.pix_idx for x in d]),
                             RenderDraws(*(torch.cat([getattr(x.render, f) for x in d]) for f in RenderDraws._fields)))
    first = mesh.devices[0]
    sampled, gt = tstep.sample_training_rays(rays[first], rgbs[first], joined.img_idx, joined.pix_idx)
    loss, _ = tstep.loss_and_metrics(state.params, sampled, gt, settings._replace(train=True), NerfMLPSpec(),
                                     joined.render)
    single = torch.autograd.grad(loss, tree_leaves(state.params))
    for a, b in zip(grads, single):
        assert float((a / k - b).abs().max() / b.abs().max()) < 0.08
    before = dict(ff.SHAPE_LAUNCHES["train_field_w256f10v4"])
    state, _ = tstep.data_parallel_step(state, replicas, rays, rgbs, d, settings, NerfMLPSpec(), schedule, mesh)
    torch.cuda.synchronize()
    after = ff.SHAPE_LAUNCHES["train_field_w256f10v4"]
    assert after["forward"] - before["forward"] == 2 * k and after["backward"] - before["backward"] == 2 * k
    d = draws(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = tstep.data_parallel_step(state, replicas, rays, rgbs, d, settings, NerfMLPSpec(), schedule, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 2 and bool(torch.isfinite(m["total_loss"]))


@pytest.mark.gpu
def test_mesh_on_two_cards(cuda):
    """`data_mesh(2)` on two cards: each shard runs under its card (the
    ctypes launches use the current device), the fused frame equals the
    single card's, and a data-parallel step leaves the second card's
    replica equal to the updated parameters."""
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh, device_count, shard_render
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings
    from nerf_workspaces_explorer_tpu_torch.train import step as tstep

    if device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh = data_mesh(2)
    kp = _kernel_params(mesh.devices[0])
    rays = _mesh_frame(mesh.devices[0])
    single = fr.render_rays_fused(kp, rays, RenderSettings(), early_stop_eps=1e-3)
    out = shard_render(kp, rays, RenderSettings(), mesh, use_fused=True)["rgb_fine"]
    assert out.device == mesh.devices[0] and torch.equal(out, single)
    state, replicas, rays_d, rgbs, draws, settings, schedule = _mesh_step_inputs(mesh.devices[0], mesh)
    state, m = tstep.data_parallel_step(state, replicas, rays_d, rgbs, draws(0), settings, NerfMLPSpec(), schedule,
                                        mesh)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m["total_loss"])) and m["trans_fine"].shape[0] == 1024
    for a, b in zip(tree_leaves(replicas[mesh.devices[1]]), tree_leaves(state.params)):
        assert a.device == mesh.devices[1] and torch.equal(a.detach().cpu(), b.detach().cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_graph_replay_equals_eager_steps(cuda, tmp_path, k):
    """Trainer(mesh=[cuda:0] * k, steps_per_call=4) on the card: the first
    K-step call runs its data-parallel steps eagerly and captures one CUDA
    graph of the four, the next two replay it; the 12 losses equal the
    eager data-parallel steps' (K = 1) to 1e-6 and the parameters agree; a
    profiler trace of the replays shows K4 and K5's kernels twice a shard
    a step, and the wrappers' counters do not move."""
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import device_kernel_counts
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh

    mesh = data_mesh(devices=[cuda] * k)
    first = mesh.devices[0]
    eager = _tiny_room_trainer(first, tmp_path, "eager", mesh=mesh)
    losses = [float(eager.step(i)["total_loss"]) for i in range(12)]
    graphed = _tiny_room_trainer(first, tmp_path, "graphed", steps_per_call=4, mesh=mesh)
    got = graphed.step_many(0)["total_loss_steps"].tolist()
    assert graphed.graph_captured and graphed._graph.graph is not None  # one graph of the four steps
    before = dict(ff.LAUNCHES)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got += graphed.step_many(4)["total_loss_steps"].tolist()
        got += graphed.step_many(8)["total_loss_steps"].tolist()
    ran = device_kernel_counts(prof)
    assert ff.LAUNCHES == before
    want = 2 * k * 2 * 4  # two nets, k shards, two calls of four steps
    assert ran.get("field_fwd_kernel") == want and ran.get("field_bwd_chain_kernel") == want, ran
    assert max(abs(a - b) for a, b in zip(got, losses)) <= 1e-6, (got, losses)
    assert graphed.state.step == 12
    for a, b in zip(tree_leaves(eager.params), tree_leaves(graphed.params)):
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("per_card", [False, True], ids=["one-graph", "graph-a-card"])
def test_mesh_graph_replays_make_no_host_sync(cuda, per_card):
    """`StepGraph(4)` of a `DataParallelBody` over cuda:0 twice, as one graph
    of the four steps and as the distinct-card design (a graph a card and
    step for the shards, one for the sum and Adam, eager copies between):
    three calls take the eager steps' losses to 1e-6, and the second call's
    replay makes no host sync (torch.cuda.set_sync_debug_mode("error"))."""
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh
    from nerf_workspaces_explorer_tpu_torch.train import step as tstep

    mesh = data_mesh(devices=[cuda] * 2)
    legs = {}
    for leg in ("eager", "graph"):
        state, replicas, rays, rgbs, draws, settings, schedule = _mesh_step_inputs(cuda, mesh)
        body = tstep.DataParallelBody(state, replicas, rays, rgbs, settings, NerfMLPSpec(), mesh)
        graph = tstep.StepGraph(4, per_card=per_card) if leg == "graph" else None
        losses = []
        for c in range(3):
            call = [draws(4 * c + i) for i in range(4)]
            if graph is None:
                state, m = tstep.take_steps(state, body, call, schedule)
            else:
                torch.cuda.synchronize()
                if c == 1:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, m = graph(state, body, call, schedule)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            losses += m["total_loss_steps"].tolist()
        legs[leg] = losses
    assert graph.captured and (graph.graph is None) == per_card
    assert state.step == 12
    assert max(abs(a - b) for a, b in zip(legs["graph"], legs["eager"])) <= 1e-6, legs


@pytest.mark.gpu
def test_mesh_graph_on_two_cards(cuda, tmp_path):
    """`Trainer(mesh=data_mesh(2), steps_per_call=4)` on two cards: a graph
    a card and step for the shards and one on the first card for the sum
    and Adam; 12 steps in three calls take the eager data-parallel steps'
    losses to 1e-6, and the second card's replica equals the parameters."""
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh, device_count

    if device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh = data_mesh(2)
    eager = _tiny_room_trainer(mesh.devices[0], tmp_path, "eager", mesh=mesh)
    losses = [float(eager.step(i)["total_loss"]) for i in range(12)]
    graphed = _tiny_room_trainer(mesh.devices[0], tmp_path, "graphed", steps_per_call=4, mesh=mesh)
    got = []
    for c in range(3):
        got += graphed.step_many(4 * c)["total_loss_steps"].tolist()
    assert graphed.graph_captured and graphed._graph.graph is None  # the per-card graphs
    assert max(abs(a - b) for a, b in zip(got, losses)) <= 1e-6, (got, losses)
    replica = graphed._mesh_shards()["params"][mesh.devices[1]]
    for a, b in zip(tree_leaves(replica), tree_leaves(graphed.params)):
        assert a.device == mesh.devices[1] and torch.equal(a.detach().cpu(), b.detach().cpu())


def _script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_gpu_{name[:-3]}", os.path.join(ROOT, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_quality_gate_on_the_card(cuda, tmp_path, monkeypatch):
    """`scripts/validate_quality_torch.py` at 200 steps on a 48x64 orbit with
    the proposal leg, the fast preset, the strided placement and a short
    turbo leg: each leg's renders launch K1/K2/K3 once a test view (and K2
    for the int8 render's merged placement), K6 and K7 for the int8 and
    fast-preset renders, its training K4/K5; the
    fidelities hold 0.99 and the PSNRs are finite. (200 steps cannot meet
    the PSNR thresholds, which are not asserted.)"""
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    vq = _script("validate_quality_torch.py")
    counters = {"K1": (fr.LAUNCHES, "density_only"), "K2": (im.LAUNCHES, "importance_merge"),
                "K3": (fr.LAUNCHES, "full"), "K4": (ff.LAUNCHES, "forward"), "K5": (ff.LAUNCHES, "backward"),
                "K6": (im.LAUNCHES, "importance_only")}
    legs = {}

    def counted(fn, name):
        def run(*args, **kwargs):
            before = {k: d[key] for k, (d, key) in counters.items()}
            before["K7"] = fr.LAUNCHES["density_only_int8"] + fr.LAUNCHES["full_int8"]
            leg = fn(*args, **kwargs)
            n = {k: d[key] - before[k] for k, (d, key) in counters.items()}
            n["K7"] = fr.LAUNCHES["density_only_int8"] + fr.LAUNCHES["full_int8"] - before["K7"]
            legs[name or args[0]] = (leg, n)
            return leg
        return run

    monkeypatch.setattr(vq, "run_leg", counted(vq.run_leg, None))
    monkeypatch.setattr(vq, "run_turbo_leg", counted(vq.run_turbo_leg, "turbo"))
    vq.main(["--steps", "200", "--height", "48", "--width", "64", "--proposal", "--fast-preset",
             "--prop-subsample", "4", "--turbo", "--turbo-steps", "100", "--out", str(tmp_path),
             "--report", str(tmp_path / "report.md")])
    n_views, n_fast = 3, 2 * 2 * 3  # two counts, exact and strided, three views
    for name in ("hier", "prop"):
        leg, n = legs[name]
        assert n["K4"] > 0 and n["K5"] > 0, (name, n)
        assert {k: n[k] for k in ("K1", "K2", "K3", "K6", "K7")} == {
            "K1": n_views, "K2": n_views + 1, "K3": n_views, "K6": n_fast, "K7": 2 + 2 * n_fast}, (name, n)
        assert leg["fidelity"] >= 0.99 and leg["fidelity_int8"] >= 0.99, (name, leg)
        assert all(np.isfinite(leg[k]) for k in ("psnr", "psnr_min", "ssim", "ssim_min")), (name, leg)
    turbo, n = legs["turbo"]
    assert all(n[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")), n
    assert all(np.isfinite(turbo[k]) for k in ("psnr", "psnr_sub", "teacher_psnr", "psnr_vs_teacher")), turbo
    assert (tmp_path / "report.md").exists()


@pytest.mark.gpu
def test_plain_field_steps_as_graph_replays(cuda, tmp_path):
    """`--field plain --steps-per-call K` (the long-horizon study's fp32
    run): the plain field's steps captured and replayed as a CUDA graph take
    the eager steps' losses."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, logging=dataclasses.replace(
        cfg.logging, step_log_print=0, step_log_tensorboard=2**31 - 1, step_save_ckpt=0, step_render_test=0,
        step_render_train=0))
    train, test, _ = make_synthetic_scene(n_train=8, n_test=2, height=48, width=64, device=cuda)
    k, calls = 10, 3
    eager = Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / "eager"),
                    enable_tensorboard=False, field_impl="plain", device=cuda)
    eager.setup()
    losses = [float(eager.step(i)["total_loss"]) for i in range(k * calls)]
    graphed = Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / "graph"),
                      enable_tensorboard=False, field_impl="plain", steps_per_call=k, device=cuda)
    graphed.setup()
    got = []
    for c in range(calls):
        got += graphed.step_many(c * k)["total_loss_steps"].tolist()
    assert graphed.graph_captured
    assert np.abs(np.array(got) - np.array(losses)).max() <= 1e-6


@pytest.mark.gpu
def test_step_many_makes_no_synchronize_once_captured(cuda, tmp_path, monkeypatch):
    """After the capture, `Trainer.step_many` (graph replays) and
    `Trainer.step` (an eager step) return with their work queued: neither
    calls `torch.cuda.synchronize`, with or without a profiler recording;
    the timer's phases resolve when read."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, logging=dataclasses.replace(
        cfg.logging, step_log_print=0, step_log_tensorboard=2**31 - 1, step_save_ckpt=0, step_render_test=0,
        step_render_train=0))
    train, test, _ = make_synthetic_scene(n_train=2, n_test=1, height=24, width=32, device=cuda)
    tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=cuda, save_dir=str(tmp_path),
                 enable_tensorboard=False, steps_per_call=4)
    tr.setup()
    tr.step_many(0)
    assert tr.graph_captured
    calls = []
    real = torch.cuda.synchronize

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    tr.step_many(4)
    tr.step(8)
    monkeypatch.undo()
    # The profiler synchronizes as it starts and stops: count inside it.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        monkeypatch.setattr(torch.cuda, "synchronize", counted)
        tr.step_many(9)
        monkeypatch.undo()
    assert calls == []
    torch.cuda.synchronize()
    assert tr.timer.counts["train_step"] + len(tr.timer._pending) == 4
    assert tr.timer.mean("train_step") > 0 and tr.timer.counts["train_step"] == 4


@pytest.mark.gpu
def test_step_timer_events_agree_with_a_synchronized_clock(cuda):
    """The timer's CUDA-event phases over 10 back-to-back calls of ~10 ms of
    device work sum to within 10% of the host clock around them, ended by a
    synchronize."""
    import time

    from nerf_workspaces_explorer_tpu_torch.obs.profiler import StepTimer

    a = torch.randn(4096, 4096, device=cuda)

    def work():
        for _ in range(4):
            a @ a

    work()
    timer = StepTimer(cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        with timer.phase("mm"):
            work()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = timer.mean("mm") * 10
    assert timer.counts["mm"] == 10
    assert abs(total - wall) <= 0.1 * wall, (total, wall)


@pytest.mark.gpu
def test_fused_path_counts_the_samples_its_kernels_evaluate(cuda, monkeypatch):
    """While a profiler records, `render_rays_fused` without `live_groups`
    counts each pass's evaluated samples as its kernel's 4-sample steps
    times 128: equal to `live_groups` of the same pass launched directly,
    and their sum to a caller's `live_groups` over both passes."""
    import dataclasses

    import numpy as np

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.obs import profiler

    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(cfg.experiment, image_width=96, image_height=64))
    r = NeRFRenderer("tokyo", CKPT, config=cfg, precision="fast", early_stop_eps=1e-3, device=cuda)
    r.initialize_models()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, -0.5, 0.5]
    rays = r._rays([pose])

    def render(**kw):
        return fr.render_rays_fused(r._kparams, rays, r._settings, early_stop_eps=1e-3, grid_hw=(64, 96), **kw)

    both = torch.zeros(1, dtype=torch.int32, device=cuda)
    render(live_groups=both)
    passes = []
    real = fr.nerf_render

    def own_counter(*args, density_only=False, live_groups=None, **kw):
        passes.append(torch.zeros(1, dtype=torch.int32, device=cuda))
        return real(*args, density_only=density_only, live_groups=passes[-1], **kw)

    monkeypatch.setattr(fr, "nerf_render", own_counter)
    render()
    monkeypatch.undo()
    profiler.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        render()
    counts = profiler.read_counters()
    profiler.reset_counters()
    density, fine = (int(t) for t in passes)
    assert density > 0 and fine > 0
    assert counts == {"render.density_samples": density * fr.STEP_POINTS,
                      "render.fine_samples": fine * fr.STEP_POINTS}
    assert density + fine == int(both)


def _frame_graph_renderer(device, kind):
    """The renderers the frame graph serves, at 320x240: the 8x256 reference
    preset at bf16 or int8 (synth_hier), the turbo student at bf16."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    cfg = load_config(office_name="tokyo")
    if kind == "turbo-fast":
        cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, depth_range=(0.1, 8.0)))
        r = NeRFRenderer("tokyo", os.path.join(ROOT, "assets", "bench", "room_proposal.npz"), config=cfg,
                         precision="fast", preset="turbo", device=device)
    else:
        r = NeRFRenderer("tokyo", CKPT, config=cfg, precision=kind.split("-")[1], device=device)
    r.initialize_models()
    return r


def _frame_graph_poses(kind, n=8):
    """n poses with content: the room's walkthrough for the turbo student,
    clicks on the tokyo plan for synth_hier."""
    from nerf_workspaces_explorer_tpu_torch.app.workspace import OfficeTokyoWorkspace
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import walkthrough_poses

    if kind == "turbo-fast":
        return [p.astype(np.float32) for p in walkthrough_poses(9 * n)[::9]]
    space = OfficeTokyoWorkspace(ckpt_path=CKPT, device="cpu")
    poses = []
    for i in range(n):
        init, coord = space.transform_relative_coordinates(0.3 + 0.08 * i, 0.5 + 0.05 * i, 30 * i, (-30, 0, 30)[i % 3])
        poses.append(poses_from_coordinates(init, [coord])[0])
    return poses


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hier-fast", "turbo-fast", "hier-int8"])
def test_frame_graph_replays_equal_eager_frames(cuda, kind):
    """A renderer's first single frame runs eagerly and captures the frame
    graph; later frames are replays, byte-equal to the eager frames of the
    same poses (the capture's pose among them), as float32 and as uint8,
    and none is overwritten by a later replay."""
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import _to_uint8

    r = _frame_graph_renderer(cuda, kind)
    poses = _frame_graph_poses(kind)
    first = r.render_pose_uint8(poses[0])
    graph = r._frame_graph
    assert graph is not None
    replayed = [r.render_pose_uint8(p) for p in poses]
    floats = [r.render_pose(p) for p in poses[:2]]
    assert r._frame_graph is graph
    eager = [r._render_batch([p])[0] for p in poses]
    assert torch.equal(first, _to_uint8(eager[0]))
    for i, (got, want) in enumerate(zip(replayed, eager)):
        assert got.dtype == torch.uint8 and torch.equal(got, _to_uint8(want)), i
    for got, want in zip(floats, eager):
        assert torch.equal(got, want)
    assert not torch.equal(replayed[0], replayed[1]) and int(replayed[0].max()) > 0


@pytest.mark.gpu
def test_frame_graph_stream_equals_per_pose_frames(cuda):
    """`render_poses_uint8_stream(lookahead=3)` queues replays three frames
    ahead of its copies to the host: every frame equals the per-pose one."""
    r = _frame_graph_renderer(cuda, "turbo-fast")
    poses = _frame_graph_poses("turbo-fast")
    streamed = list(r.render_poses_uint8_stream(poses, lookahead=3))
    single = [r.render_pose_uint8(p).cpu().numpy() for p in poses]
    assert len(streamed) == len(poses)
    for got, want in zip(streamed, single):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_frame_graph_after_set_params_renders_the_new_weights(cuda):
    """`set_params` drops the frame graph: the next frame is eager on the
    new weights and captures anew, and the replays after it equal eager
    frames on the new weights."""
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import _to_uint8

    r = _frame_graph_renderer(cuda, "hier-fast")
    poses = _frame_graph_poses("hier-fast", 3)
    old = [r.render_pose_uint8(p) for p in poses]
    tree, _, _ = load_checkpoint(CKPT)
    tree = {k: dict(v) for k, v in tree.items()}
    tree["fine"] = {k: (dict(v, b=np.asarray(v["b"]) - 0.5) if k == "rgb" else v) for k, v in tree["fine"].items()}
    r.set_params(tree)
    assert r._frame_graph is None
    new = [r.render_pose_uint8(p) for p in poses + poses[:1]]
    assert r._frame_graph is not None
    for got, p in zip(new, poses + poses[:1]):
        assert torch.equal(got, _to_uint8(r._render_batch([p])[0]))
    assert not torch.equal(new[1], old[1])


@pytest.mark.gpu
def test_frame_graph_replays_are_counted_from_a_trace(cuda):
    """`LAUNCHES` counts wrapper calls, as for the training step's graph:
    the capture's calls count, a replay moves no counter, and a profiler
    trace of the replays counts the kernels they ran, one density pass,
    one placement and one fine pass a frame."""
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import device_kernel_counts

    r = _frame_graph_renderer(cuda, "turbo-fast")
    poses = _frame_graph_poses("turbo-fast", 3)
    counters = (fr.LAUNCHES, im.LAUNCHES)
    before = [dict(c) for c in counters]
    r.warmup()  # the preview, then the eager frame and the capture
    delta = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
    assert delta == {"density_only": 3, "full": 3, "importance_only": 3}, delta
    assert r._frame_graph is not None
    before = [dict(c) for c in counters]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for p in poses:
            r.render_pose_uint8(p)
        torch.cuda.synchronize()
    ran = device_kernel_counts(prof)
    assert [dict(c) for c in counters] == before
    assert ran.get("render_kernel") == 6 and ran.get("importance_merge_kernel") == 3, ran


@pytest.mark.gpu
def test_frame_graph_counts_the_eager_frames_samples(cuda):
    """Inside a profiler session, replays add to `render.density_samples`
    and `render.fine_samples` what eager frames of the same poses count,
    and count themselves in `render.graph_replays`."""
    from nerf_workspaces_explorer_tpu_torch.obs import profiler

    r = _frame_graph_renderer(cuda, "hier-fast")
    poses = _frame_graph_poses("hier-fast", 4)
    r.render_pose_uint8(poses[0])
    assert r._frame_graph is not None
    counts = []
    for frame in (r.render_pose_uint8, lambda p: r._render_batch([p])):
        profiler.reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            for p in poses:
                frame(p)
        counts.append(profiler.read_counters())
    profiler.reset_counters()
    replayed, eager = counts
    assert replayed.pop("render.graph_replays") == len(poses)
    assert eager["render.density_samples"] > 0 and eager["render.fine_samples"] > 0
    assert replayed == eager, (replayed, eager)


# ---------------------------------------------------------------------------
# mip-NeRF 360 (K10-K13, csrc/mipnerf360.cu) at the published widths,
# against their plain versions on the same inputs.

def _m360(device, seed=3):
    from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import Mip360Spec, init_params
    from nerf_workspaces_explorer_tpu_torch.ops import mipnerf360 as m3

    spec = Mip360Spec()
    return m3, m3.Mip360Model(init_params(seed, spec), spec, device)


def _m360_rays(device, n_rays, seed=0):
    from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays

    g = torch.Generator().manual_seed(seed)
    c2w = torch.eye(4)
    c2w[:3, :3] = torch.linalg.qr(torch.randn(3, 3, generator=g))[0]
    c2w[:3, 3] = torch.randn(3, generator=g)
    w = 32
    rays = create_rays(c2w, n_rays // w, w, 160.0, 160.0, 159.5, 119.5, 0.1, 10.0).reshape(n_rays)
    radii = torch.full((n_rays,), (1 / 160.0) * 2 / np.sqrt(12))
    return [t.to(device).contiguous() for t in (rays.origins, rays.dirs, rays.viewdirs, radii)]


def _m360_level(m3, model, device, n_rays, n, seed=0):
    """Rays (scaled) and a level's intervals from a seed-drawn step function."""
    o, d, v, rad = _m360_rays(device, n_rays, seed)
    s = np.float32(model.spec.scene_scale)
    g = torch.Generator().manual_seed(seed + 1)
    w_in = torch.rand(n_rays, 64, generator=g).to(device) ** 4
    t_in = torch.sort(torch.rand(n_rays, 65, generator=g), -1).values.to(device)
    t_in[:, 0], t_in[:, -1] = 0.0, 1.0
    sd, td = m3.place_plain(t_in, w_in, 0.01, n, model.spec)
    return (o / s).contiguous(), (d / s).contiguous(), (rad / s).contiguous(), v, sd, td


@pytest.mark.gpu
@pytest.mark.parametrize("dilation", [None, 0.0025 + 0.5 / 64], ids=["plain", "dilated"])
def test_m360_place_kernel_matches_plain(cuda, dilation):
    m3, model = _m360(cuda)
    g = torch.Generator().manual_seed(11)
    n_rays = 1000
    w_in = (torch.rand(n_rays, 64, generator=g) ** 4).to(cuda)
    w_in[::7, 10:40] = 0.0  # empty stretches
    t_in = torch.sort(torch.rand(n_rays, 65, generator=g), -1).values.to(cuda)
    t_in[:, 0], t_in[:, -1] = 0.0, 1.0
    t_in[::5, 20:23] = t_in[::5, 20:21]  # zero-width intervals
    for n in (64, 32):
        s_k, t_k = m3.place(t_in, w_in, dilation, n, model.spec)
        s_p, t_p = m3.place_plain(t_in, w_in, dilation, n, model.spec)
        # the CDF's sums in another order move a centre by its slope times
        # ~1e-7; where a quantile falls on a flat stretch of the CDF (an empty
        # interval) an ulp moves it across the stretch: a few centres in 1e4
        off = (s_k - s_p).abs() > 2e-5
        assert off.float().mean().item() <= 1e-3, off.sum().item()
        torch.testing.assert_close(t_k, m3.s_to_t(s_k, model.spec), rtol=1e-5, atol=0)
        assert bool((s_k[:, 1:] >= s_k[:, :-1]).all())


@pytest.mark.gpu
def test_m360_encode_kernel_matches_plain(cuda):
    m3, model = _m360(cuda)
    o, d, rad, _, _, td = _m360_level(m3, model, cuda, 256, 64)
    k = m3.from_slabs(m3.encode_slabs(o, d, rad, td, model), 256 * 64, 504).float()
    p = m3.encode_plain(o, d, rad, td, model)
    # both bf16 (an ulp 2^-8 of |x| <= 1); the kernel's polynomial sine and
    # cosine after an exact reduction differ from torch's by ~1e-6 before it
    assert (k - p).abs().max().item() <= 2**-8
    assert (k - p).abs().mean().item() <= 1e-4
    pad = m3.from_slabs(m3.encode_slabs(o, d, rad, td, model), 256 * 64, 512)[:, 504:]
    assert bool((pad == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["prop", "nerf"])
def test_m360_mlp_kernels_match_plain(cuda, net):
    m3, model = _m360(cuda)
    n_rays = 256 if net == "prop" else 512
    n = 64 if net == "prop" else 32
    o, d, rad, v, _, td = _m360_level(m3, model, cuda, n_rays, n)
    enc = m3.encode_slabs(o, d, rad, td, model)
    x = m3.from_slabs(enc, n_rays * n, 504).float()
    rows = n_rays * n
    if net == "prop":
        raw = torch.empty((rows, 1), device=cuda)
        m3.prop_density_slabs(model, enc, rows, raw)
        raw_p = m3.prop_density_plain(model, x)
    else:
        from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import view_encoding

        nv = model.params["nerf"]["view"]
        vray = (m3._bf(view_encoding(v, 4)) @ m3._bf(nv["w"][256:]) + nv["b"]).contiguous()
        raw = torch.empty((rows, 4), device=cuda)
        rgb = torch.empty((rows, 3), device=cuda)
        m3.nerf_slabs(model, enc, rows, vray, n, raw, rgb)
        raw_p, rgb_p = m3.nerf_plain(model, x, vray, n)
        # bf16 activations through 8 layers: a row's sums in another order
        # move an activation by an ulp (2^-8) now and then
        torch.testing.assert_close(rgb, rgb_p, rtol=0, atol=2e-2)
        assert (rgb - rgb_p).abs().mean().item() < 2e-3
    torch.testing.assert_close(raw.sum(-1, keepdim=True), raw_p, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_m360_composite_kernel_matches_plain(cuda):
    m3, model = _m360(cuda)
    g = torch.Generator().manual_seed(5)
    n_rays, n = 1000, 32
    td = torch.sort(torch.rand(n_rays, n + 1, generator=g) * 10 + 0.1, -1).values.to(cuda)
    raw = (torch.randn(n_rays * n, 4, generator=g) * 2).to(cuda)
    rgb = torch.rand(n_rays * n, 3, generator=g).to(cuda)
    dn = (torch.rand(n_rays, generator=g) + 0.5).to(cuda)
    w_k, c_k = m3.composite(td, raw, 0.0, dn, rgb)
    w_p, c_p = m3.composite_plain(td, raw, 0.0, dn, rgb)
    torch.testing.assert_close(w_k, w_p, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(c_k, c_p, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_m360_frame_matches_plain_reference(cuda):
    """A few hundred rays through the card's path against the plain float32
    reference (`benchmark/reference/mipnerf360.py`) at the published widths."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark", "reference",
                        "mipnerf360.py")
    mod_spec = importlib.util.spec_from_file_location("bench_reference_mipnerf360", path)
    plain = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(plain)
    m3, model = _m360(cuda, seed=2022)
    o, d, v, rad = _m360_rays(cuda, 512, seed=4)
    rgb = m3.render_rays_mip360(model, o, d, v, rad)
    s = np.float32(model.spec.scene_scale)
    ref = plain.render_rays(plain.init_params(2022, model.spec.to_dict(), cuda), o / s, d / s, v, rad / s,
                            model.spec.to_dict())
    err = (rgb - ref).abs()
    print(f"m360 frame vs plain: mean {err.mean().item():.3e} max {err.max().item():.3e}")
    # bf16 products against float32 (measured: mean 6.1e-4): the colours'
    # mean gap stays under half a uint8 level, the worst under 4 (placement
    # moves with the proposal's rounding)
    assert err.mean().item() < 2e-3
    assert err.max().item() < 1.6e-2
