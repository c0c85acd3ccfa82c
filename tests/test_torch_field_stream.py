"""The training field's packed weight stream (`ops/fused_field.py::
pack_field_stream`, read by K4/K5 in csrc/train_field.cu) on the CPU: the
slabs come in the order and with the byte counts the kernels' consumers take
them (`field_stream_rows`), each 128-byte aligned; un-swizzling each slab
gives the JAX kernel's inputs (`pallas_train._build_kernel_inputs`) exactly,
with zeros in the padding; the training step's pack from the leaves
(`_pack_leaves`, one gather) holds the same values, and its gradient gather
is `grads_to_tree`. Covers the skip at layer 5, no skip, a skip at layer 2
of a 4-layer net, the 2x64@6f/2f proposal net (no skip), and the distilled
students: 6x192@10f (its skip at layer 5, and 192-wide layers that end in a
64-byte slab after full ones) and 4x128@8f (no skip, a 56-column encoding)."""

import jax
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.ops import pallas_train as jpt
from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, tree_leaves
from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

torch.set_num_threads(2)

SPECS = {"8x256-skip5": dict(), "8x256-no-skip": dict(skips=()), "4x256-skip2": dict(depth=4, skips=(1,)),
         "2x64-proposal": "proposal", "6x192@10f-skip5": dict(depth=6, width=192),
         "4x128@8f": dict(depth=4, width=128, input_ch=51)}


def _specs(name):
    """(JAX spec, port spec) of a case: the proposal net from each package's
    `proposal_spec`."""
    kwargs = SPECS[name]
    if kwargs == "proposal":
        return jproposal_spec(6), proposal_spec(6)
    return JSpec(**kwargs), NerfMLPSpec(**kwargs)


def _nets(name):
    jspec, spec = _specs(name)
    params = init_nerf_params(jax.random.PRNGKey(len(name)), jspec)
    mine = params_from_numpy(jax.tree.map(np.asarray, params))
    inputs, meta = ff.build_kernel_inputs(mine, spec)
    return params, mine, spec, inputs, meta


def _expected_tables(depth, skip_layer, width=256, enc=64, venc=32):
    """(forward, backward) lists of (name, rows, k_bytes) per slab, written
    out from the kernels' note: a matrix [rows, K] of bf16 takes ceil(2 K /
    128) slabs; its k_bytes are 2 K rounded up to the 32-byte k-step. enc
    and venc are the encodings' padded widths (64 and 32 at 10 and 4
    frequencies, 56 at 8, 40 and 16 at 6 and 2)."""
    w, half = width, width // 2
    kb = lambda k: -(-2 * k // 32) * 32  # noqa: E731
    trunk = [("w0", w, kb(enc))]
    for i in range(1, depth):
        if i == skip_layer:
            trunk.append((f"wskip{i}", w, kb(enc)))
        trunk.append((f"w{i}", w, 2 * w))
    view = [("w_feature", w, 2 * w), ("w_view_h", half, 2 * w), ("w_view_enc", half, kb(venc))]
    forward = trunk + [("w_alpha", 16, 2 * w)] + view + [("w_rgb", 16, 2 * half)]
    backward = trunk + view + [("w_rgb_t", half, 32), ("w_view_h_t", w, 2 * half), ("w_feature_t", w, 2 * w),
                               ("w_alpha_t", w, 32)] + [(f"w{i}_t", w, 2 * w) for i in range(depth - 1, 0, -1)]

    def slabs(mats):
        return [(name, rows, kb) for name, rows, kb in mats for _ in range(-(-kb // 128))]

    return slabs(forward), slabs(backward)


def _unswizzle(slab, rows):
    """[rows * 64] slab values -> [rows, 64]: value e of row r sits at r * 64
    + (((e >> 3) ^ r) & 7) * 8 + (e & 7) (128-byte swizzle, 2-byte values)."""
    r = np.arange(rows)[:, None]
    e = np.arange(64)[None, :]
    return slab[r * 64 + (((e >> 3) ^ r) & 7) * 8 + (e & 7)]


def _matrix(ws, table, name):
    """The matrix `name` reassembled from its slabs of `table`."""
    buf = ws.buffer.float().numpy()
    entries = [e for e in table if e[0] == name]
    cols = [_unswizzle(buf[e[1] // 2: (e[1] + e[2]) // 2], e[3]) for e in entries]
    return np.concatenate(cols, 1), entries[0][4]


@pytest.mark.parametrize("name", SPECS)
def test_slab_order_and_bytes(name):
    _, _, spec, inputs, meta = _nets(name)
    ws = ff.pack_field_stream(inputs, meta)
    skip = spec.skips[0] + 1 if spec.skips else -1
    enc, venc = -(-spec.input_ch // 8) * 8, -(-spec.input_ch_views // 8) * 8
    want_fwd, want_bwd = _expected_tables(spec.depth, skip, spec.width, enc, venc)
    for table, want in ((ws.layout.forward, want_fwd), (ws.layout.backward, want_bwd)):
        assert [(e[0], e[3], e[4]) for e in table] == want
        assert all(e[2] == e[3] * 128 and e[1] % 128 == 0 for e in table)
    # One buffer: every slab once, back to back, the backward reusing the
    # forward's trunk, feature and view slabs.
    spans = sorted({(e[1], e[2]) for e in ws.layout.forward + ws.layout.backward})
    assert spans[0][0] == 0 and all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] == 2 * ws.buffer.numel() == 2 * ws.layout.n_elems
    # The buffer's start is the allocator's (512-byte aligned on the card,
    # where the launch checks 128).
    assert ws.buffer.dtype == torch.bfloat16


@pytest.mark.parametrize("name", SPECS)
def test_slabs_hold_the_jax_kernel_inputs(name):
    """Each matrix un-swizzled is the JAX kernel's input (transposed where
    the backward multiplies by W^T; the heads padded: alpha and rgb to 16
    rows, rgb^T in columns 0-2 and alpha^T in column 8 of 16), zero past
    its width."""
    params, _, spec, inputs, meta = _nets(name)
    ref, _ = jpt._build_kernel_inputs(params, _specs(name)[0])
    ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    ws = ff.pack_field_stream(inputs, meta)

    def pad(a, rows, cols, at=0):
        out = np.zeros((rows, cols), np.float32)
        out[: a.shape[0], at: at + a.shape[1]] = a
        return out

    want = {k: v for k, v in ref.items() if k.startswith("w") and k not in (
        "w_alpha", "w_rgb", "w_alpha_t", "w_rgb_t")}
    w = spec.width
    want["w_alpha"] = pad(ref["w_alpha"], 16, w)
    want["w_rgb"] = pad(ref["w_rgb"], 16, w // 2)
    want["w_alpha_t"] = pad(ref["w_alpha_t"][:, 0:1], w, 16, 8)
    want["w_rgb_t"] = pad(ref["w_rgb_t"][:, 0:3], w // 2, 16)
    names = {e[0] for e in ws.layout.forward + ws.layout.backward}
    assert names == set(want)
    for key, w in want.items():
        table = ws.layout.forward if any(e[0] == key for e in ws.layout.forward) else ws.layout.backward
        got, k_bytes = _matrix(ws, table, key)
        assert k_bytes == -(-w.shape[1] * 2 // 32) * 32, key
        np.testing.assert_array_equal(got[:, : w.shape[1]], w, err_msg=key)
        assert not got[:, w.shape[1]:].any(), key


@pytest.mark.parametrize("name", SPECS)
def test_leaf_pack_equals_input_pack(name):
    """The step's pack (a gather of the leaves, cast to bf16) holds the values
    of `pack_field_stream(build_kernel_inputs(...))`, with the same layout and
    biases."""
    _, mine, spec, inputs, meta = _nets(name)
    assert ff.field_meta(spec) == meta
    ws = ff.pack_field_stream(inputs, meta)
    got, _ = ff._pack_leaves(mine, tree_leaves(mine), spec, meta)
    assert got.layout == ws.layout
    assert torch.equal(got.buffer.float(), ws.buffer.float())
    assert len(got.biases) == len(ws.biases) == meta["n_layers"] + 4
    for a, b in zip(got.biases, ws.biases):
        n = a.numel()  # the leaves' alpha and rgb biases are unpadded
        assert torch.equal(a, b[:n]) and not b[n:].any()


@pytest.mark.parametrize("name", SPECS)
def test_gradient_gather_is_grads_to_tree(name):
    """The step's gather of the kernel's [dW, db] buffer into leaf order
    equals `grads_to_tree` of the named kernel-layout gradients."""
    _, mine, spec, _, meta = _nets(name)
    _, grad_index = ff._pack_leaves(mine, tree_leaves(mine), spec, meta)
    shapes = ff.grad_shapes(meta)
    n_dw = sum(int(np.prod(s)) for k, s in shapes.items() if k.startswith("dw"))
    n_db = sum(s[0] for k, s in shapes.items() if k.startswith("db"))
    flat = torch.from_numpy(np.random.default_rng(3).normal(size=n_dw + n_db).astype(np.float32))
    ref = tree_leaves(ff.grads_to_tree(ff._split_grads(meta, flat[:n_dw], flat[n_dw:]), meta))
    got = flat.index_select(0, grad_index).split([x.numel() for x in ref])
    for a, b, p in zip(got, ref, tree_leaves(mine)):
        assert torch.equal(a.view(b.shape), b) and tuple(b.shape) == tuple(p.shape)


def test_forward_only_inputs_pack_no_backward_table():
    _, mine, spec, _, _ = _nets("8x256-skip5")
    inputs, meta = ff.build_kernel_inputs(mine, spec, with_transposed=False)
    ws = ff.pack_field_stream(inputs, meta)
    assert ws.layout.backward == () and len(ws.layout.forward) == 45
