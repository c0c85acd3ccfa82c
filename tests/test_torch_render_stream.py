"""The render kernel's weight stream (`ops/fused_render.py::pack_weight_stream`)
on the CPU: for every network shape the kernel is built for and every mode,
the slabs come in the order and with the byte counts the kernel's consumers
take them (csrc/fused_render.cu, `stream_rows`), each 128-byte aligned, and
un-swizzling each slab with the source's formula returns the KernelParams
weights exactly, with zeros in the padding."""

import functools
import os

import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint, params_from_numpy
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_trunk, spec_from_net_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The kernel's built shapes (ops/_build.py RENDER_SHAPES) from the in-repo
# checkpoints: (file, net) -> (width, point frequencies, full pass built).
NETS = {
    "proposal-64f6": ("room_proposal.turbo.npz", "proposal", 64, 6, False),
    "student-128f8": ("synth_proposal.turbo.npz", "fine", 128, 8, True),
    "student-192f10": ("room_proposal.turbo.npz", "fine", 192, 10, True),
    "fine-256f10": ("synth_hier.npz", "fine", 256, 10, True),
}
MODES = ("bf16", "int8-trunk", "int8")
CASES = [(n, m) for n in NETS for m in MODES]


def test_cases_cover_the_built_shapes():
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    assert {(w, f): full for _, _, w, f, full in NETS.values()} == _build.RENDER_SHAPES


@functools.lru_cache(maxsize=None)
def _kernel_params(net, mode):
    path, key, width, freqs, _ = NETS[net]
    tree, _, _ = load_checkpoint(os.path.join(ROOT, "assets", "bench", path))
    params = params_from_numpy(tree[key], torch.device("cpu"))
    spec = spec_from_net_params(params)
    quant = None if mode == "bf16" else calibrate_trunk(params, spec, heads=mode == "int8")
    kp = fr.prepare_kernel_params(params, spec, quant=quant)
    assert (kp.width, kp.pts_freqs) == (width, freqs)
    return kp


def _expected_slabs(kp, full):
    """(name, rows, k_bytes) per slab of one step, written out from the
    kernel's note: a matrix [rows, K] of e-byte elements takes
    ceil(round_up(K e, 32) / 128) slabs."""
    w = kp.width
    et = 2 if kp.mode == fr.MODE_BF16 else 1
    eh = 1 if kp.mode == fr.MODE_INT8 else 2
    enc = -(-(3 + 6 * kp.pts_freqs) // 8) * 8
    mats = [("layer0", w, enc * et)]
    for i in range(1, len(kp.w_layers)):
        if kp.skips and i == kp.skips[0] + 1:
            mats.append(("skip", w, enc * et))
        mats.append((f"layer{i}", w, w * et))
    n_trunk = sum(-(-(-(-kb // 32) * 32) // 128) for _, _, kb in mats)
    if full:
        # The 256-wide net runs alpha and the features as two products.
        fa = [("alpha", 16, w * eh), ("feature", w, w * eh)] if w == 256 else [("feature+alpha", w + 16, w * eh)]
        mats += fa + [("view", w // 2, w * eh), ("rgb", 16, w // 2 * eh)]
    else:
        mats.append(("alpha", 16, w * eh))
    slabs = []
    for name, rows, kb in mats:
        kb = -(-kb // 32) * 32
        slabs += [(name, rows, kb)] * (-(-kb // 128))
    return slabs, n_trunk


def _tables(net):
    return ("density", "full") if NETS[net][4] else ("density",)


@pytest.mark.parametrize("net,mode", CASES)
def test_stream_order_and_bytes(net, mode):
    kp = _kernel_params(net, mode)
    ws = fr.pack_weight_stream(kp)
    for table in _tables(net):
        want, n_trunk = _expected_slabs(kp, table == "full")
        got = getattr(ws, table)
        assert [(e[0], e[3], e[4]) for e in got] == want
        assert [e[2] for e in got] == [rows * 128 for _, rows, _ in want]
        assert ws.n_trunk == n_trunk
        assert len(got) <= 96  # the kernel's MAX_SLABS


@pytest.mark.parametrize("net,mode", CASES)
def test_stream_slabs_are_aligned(net, mode):
    kp = _kernel_params(net, mode)
    ws = fr.pack_weight_stream(kp)
    assert ws.buffer.dtype == torch.uint8 and ws.buffer.data_ptr() % 128 == 0
    slabs = sorted({e[1:3] for t in (ws.density, ws.full) for e in t})
    ends = [0] + [o + n for o, n in slabs]
    assert [o for o, _ in slabs] == ends[:-1] and ends[-1] == ws.buffer.numel()  # contiguous, no overlap
    for off, size in slabs:
        # Slabs start 128-byte aligned; whole 8-row groups keep a ring stage
        # 1024-aligned for the swizzle.
        assert off % 128 == 0 and size % 1024 == 0


def _unswizzle(slab: np.ndarray, rows: int) -> np.ndarray:
    """[rows * 128] stored bytes -> [rows, 128] logical bytes, by the
    formula of csrc/fused_render.cu: byte b of row r at
    r * 128 + (((b >> 4) ^ r) & 7) * 16 + (b & 15)."""
    r = np.arange(rows)[:, None]
    b = np.arange(128)[None, :]
    return slab[r * 128 + (((b >> 4) ^ r) & 7) * 16 + (b & 15)]


def _matrices(kp):
    w = kp.width
    mats = {"layer0": kp.w_layers[0], "feature+alpha": kp.w_fa[: w + 16], "alpha": kp.w_fa[w : w + 16],
            "feature": kp.w_fa[:w],
            "view": kp.w_view_h, "rgb": kp.w_rgb}
    mats.update({f"layer{i}": t for i, t in enumerate(kp.w_layers) if i})
    if kp.w_skip_enc:
        mats["skip"] = kp.w_skip_enc[0]
    return mats


@pytest.mark.parametrize("net,mode", CASES)
def test_stream_unswizzles_to_the_weights(net, mode):
    kp = _kernel_params(net, mode)
    ws = fr.pack_weight_stream(kp)
    buf = ws.buffer.numpy()
    mats = _matrices(kp)
    for table in _tables(net):
        by_name = {}
        for name, off, size, rows, k_bytes in getattr(ws, table):
            by_name.setdefault(name, []).append(_unswizzle(buf[off: off + size], rows))
        assert set(by_name) <= set(mats)
        for name, parts in by_name.items():
            m = mats[name]
            want = m.contiguous().view(torch.uint8).reshape(m.shape[0], -1).numpy()
            got = np.concatenate(parts, axis=1)
            np.testing.assert_array_equal(got[:, : want.shape[1]], want, err_msg=f"{table} {name}")
            assert not got[:, want.shape[1]:].any(), f"{table} {name}: nonzero padding"


def test_weight_stream_packs_once_per_parameter_set():
    kp = _kernel_params("student-128f8", "int8")
    ws = fr.weight_stream(kp)
    assert fr.weight_stream(kp) is ws
    other = kp._replace(k_hv=kp.k_hv)  # equal fields, another parameter set
    assert fr.weight_stream(other) is not ws
    torch.testing.assert_close(fr.weight_stream(other).buffer, ws.buffer, rtol=0, atol=0)
