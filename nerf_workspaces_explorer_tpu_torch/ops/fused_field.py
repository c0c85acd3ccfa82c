"""The fused training field: encode + MLP forward and backward over free
sample points, as a `torch.autograd.Function`.

Counterpart of `nerf_workspaces_explorer_tpu/ops/pallas_train.py`.
`fused_field(params, spec, pts, viewdirs)` computes what encode +
`apply_nerf_mlp` computes (raw rgb logits and sigma, [N, 4]), with the
numerics of the TPU kernels: the octave-ladder encoding of `x / 10` and of
the view directions, bf16 operands with fp32 accumulation, bf16 activations,
heads padded to 8 rows. Its backward is written out, not left to autograd:
the cotangent is cast to bf16 before each product, ReLU masks come from the
recomputed bf16 activations, bias gradients are fp32 sums of the fp32
cotangent (of its bf16 values for the view layer, as the TPU kernel sums
them), the trunk stops at layer 0, and points and view directions get zero
cotangents (importance depths are detached and rays are data).

Two kernels, `csrc/train_field.cu`, every product a bf16 wgmma, built once
per network shape of `KERNEL_SHAPES` (the stock 8x256@10f/4f net, the
2x64@6f/2f proposal net, and the distilled students 6x192@10f/4f and
4x128@8f/4f; any other shape raises on the card):
  - K4 `field_forward` (replaces `pallas_train.py::_fwd_kernel`);
  - K5 `field_backward` (replaces `::_bwd_kernel`): recompute + input-
    gradient chain, split-K weight-gradient products and an ordered
    reduction, four launches, deterministic (see the source's notes).
Both read the net's weights as one packed stream of swizzled slabs
(`pack_field_stream`), which the training step packs from the leaves on the
device with one gather (`_pack_leaves`), and K5's gradient buffer goes back
to the leaves with another. Each launches its kernel for CUDA tensors and
runs its plain PyTorch version (`field_forward_plain`,
`field_backward_plain`) for CPU tensors. Arrays at these functions keep the
JAX package's layouts ([3, N] points, [8, N] raw, kernel-layout gradients
named as `_grad_names`), so the tests compare like with like.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.models.mlp import (
    NerfMLPSpec,
    tree_leaves,
    tree_unflatten,
)
from nerf_workspaces_explorer_tpu_torch.ops import _build
from nerf_workspaces_explorer_tpu_torch.ops.fused_render import (
    KERNEL_MAX_DEPTH,
    _bf,
    _enc_dim,
    _encode_ladder,
    _encoding_permutation,
    _freqs_from_input_ch,
    _permute_pad_in_rows,
)

# The network shapes (width, point frequencies, view frequencies) the
# training field kernels are built for, one library each: the stock 8x256
# net, the 2x64 proposal net and the two students.
KERNEL_SHAPES = _build.FIELD_SHAPES

# Launches: K4 calls, K5 calls, and the kernels K5 launches (BACKWARD_KERNELS
# per call: the chain, the weight gradients, two ordered reductions); and
# the K4 and K5 calls by library (network shape).
LAUNCHES = {"forward": 0, "backward": 0, "backward_kernels": 0}
BACKWARD_KERNELS = 4
SHAPE_LAUNCHES = {_build.field_library(*shape): {"forward": 0, "backward": 0} for shape in KERNEL_SHAPES}

# Points per partial sum of the weight-gradient products (K5).
DW_CHUNK = 4096
# Head-cotangent column of sigma in the K5 kernel's [N, 16] head tile.
_GH_SIGMA = 8


def build_kernel_inputs(
    params: Dict[str, Any], spec: NerfMLPSpec, *, with_transposed: bool = True
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Named kernel-layout tensors (weights [out, in] bf16, biases [out, 1]
    fp32) and static meta, as `pallas_train._build_kernel_inputs`.
    `with_transposed=False` (the forward) leaves out the `*_t` transposes."""
    pts_freqs = _freqs_from_input_ch(spec.input_ch)
    view_freqs = _freqs_from_input_ch(spec.input_ch_views)
    pts_perm = _encoding_permutation(pts_freqs, _enc_dim(pts_freqs))
    view_perm = _encoding_permutation(view_freqs, _enc_dim(view_freqs))
    width = spec.width
    cast = lambda x: x.to(torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda x: x.detach().to(torch.float32)  # noqa: E731
    col = lambda b: f32(b)[:, None].contiguous()  # noqa: E731

    inputs: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["pts"]):
        w = f32(layer["w"])
        if i == 0:
            wk = _permute_pad_in_rows(w, pts_perm).T
        elif (i - 1) in spec.skips:
            inputs[f"wskip{i}"] = cast(_permute_pad_in_rows(w[: spec.input_ch], pts_perm).T)
            wk = w[spec.input_ch :].T
        else:
            wk = w.T
        inputs[f"w{i}"] = cast(wk)
        if with_transposed and i > 0:
            inputs[f"w{i}_t"] = cast(wk.T)
        inputs[f"b{i}"] = col(layer["b"])

    device = inputs["w0"].device
    w_feature = f32(params["feature"]["w"]).T
    inputs["w_feature"] = cast(w_feature)
    if with_transposed:
        inputs["w_feature_t"] = cast(w_feature.T)
    inputs["b_feature"] = col(params["feature"]["b"])
    w_alpha = torch.zeros((8, width), dtype=torch.float32, device=device)
    w_alpha[0:1] = f32(params["alpha"]["w"]).T
    inputs["w_alpha"] = cast(w_alpha)
    if with_transposed:
        inputs["w_alpha_t"] = cast(w_alpha.T)
    b_alpha = torch.zeros((8, 1), dtype=torch.float32, device=device)
    b_alpha[0, 0] = f32(params["alpha"]["b"])[0]
    inputs["b_alpha"] = b_alpha
    w_view = f32(params["views"][0]["w"])
    w_view_h = w_view[:width].T
    inputs["w_view_h"] = cast(w_view_h)
    if with_transposed:
        inputs["w_view_h_t"] = cast(w_view_h.T)
    inputs["w_view_enc"] = cast(_permute_pad_in_rows(w_view[width:], view_perm).T)
    inputs["b_view"] = col(params["views"][0]["b"])
    w_rgb = torch.zeros((8, width // 2), dtype=torch.float32, device=device)
    w_rgb[:3] = f32(params["rgb"]["w"]).T
    inputs["w_rgb"] = cast(w_rgb)
    if with_transposed:
        inputs["w_rgb_t"] = cast(w_rgb.T)
    b_rgb = torch.zeros((8, 1), dtype=torch.float32, device=device)
    b_rgb[:3, 0] = f32(params["rgb"]["b"])
    inputs["b_rgb"] = b_rgb

    meta = dict(
        n_layers=len(params["pts"]),
        skips=tuple(spec.skips),
        pts_freqs=pts_freqs,
        view_freqs=view_freqs,
        width=width,
        input_ch=spec.input_ch,
        input_ch_views=spec.input_ch_views,
    )
    return inputs, meta


def grad_names(meta: Dict[str, Any]) -> List[str]:
    """Kernel-layout gradient names in the kernel's order (`_grad_names`)."""
    names = []
    for i in range(meta["n_layers"]):
        names.append(f"dw{i}")
        if i >= 1 and (i - 1) in meta["skips"]:
            names.append(f"dwskip{i}")
        names.append(f"db{i}")
    names += ["dw_feature", "db_feature", "dw_alpha", "db_alpha",
              "dw_view_h", "dw_view_enc", "db_view", "dw_rgb", "db_rgb"]
    return names


def grad_shapes(meta: Dict[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """Their shapes (`_grad_shapes`): dW [out, in], db [out, 1]."""
    width = meta["width"]
    enc, venc = _enc_dim(meta["pts_freqs"]), _enc_dim(meta["view_freqs"])
    shapes = {}
    for i in range(meta["n_layers"]):
        shapes[f"dw{i}"] = (width, enc if i == 0 else width)
        if i >= 1 and (i - 1) in meta["skips"]:
            shapes[f"dwskip{i}"] = (width, enc)
        shapes[f"db{i}"] = (width, 1)
    shapes.update(
        dw_feature=(width, width), db_feature=(width, 1), dw_alpha=(8, width),
        db_alpha=(8, 1), dw_view_h=(width // 2, width), dw_view_enc=(width // 2, venc),
        db_view=(width // 2, 1), dw_rgb=(8, width // 2), db_rgb=(8, 1),
    )
    return shapes


def _inverse_perm_rows(dwk_t: torch.Tensor, perm: np.ndarray, n_ref_rows: int) -> torch.Tensor:
    """[enc_dim, out] kernel-row grads -> [n_ref_rows, out] reference rows."""
    inv = np.zeros((n_ref_rows,), dtype=np.int64)
    for kernel_row, ref_row in enumerate(perm):
        if ref_row >= 0:
            inv[ref_row] = kernel_row
    return dwk_t[torch.as_tensor(inv, device=dwk_t.device)]


def grads_to_tree(kgrads: Dict[str, torch.Tensor], meta: Dict[str, Any]) -> Dict[str, Any]:
    """Kernel-layout grads -> the parameter tree's layout (`_grads_to_pytree`):
    inverse encoding permutation, skip and view concat splits, heads
    un-padded."""
    pts_perm = _encoding_permutation(meta["pts_freqs"], _enc_dim(meta["pts_freqs"]))
    view_perm = _encoding_permutation(meta["view_freqs"], _enc_dim(meta["view_freqs"]))
    pts = []
    for i in range(meta["n_layers"]):
        dwk = kgrads[f"dw{i}"]
        if i == 0:
            dw = _inverse_perm_rows(dwk.T, pts_perm, meta["input_ch"])
        elif (i - 1) in meta["skips"]:
            d_enc = _inverse_perm_rows(kgrads[f"dwskip{i}"].T, pts_perm, meta["input_ch"])
            dw = torch.cat([d_enc, dwk.T], 0)
        else:
            dw = dwk.T
        pts.append({"w": dw, "b": kgrads[f"db{i}"][:, 0]})
    dview = torch.cat(
        [kgrads["dw_view_h"].T,
         _inverse_perm_rows(kgrads["dw_view_enc"].T, view_perm, meta["input_ch_views"])], 0
    )
    return {
        "pts": pts,
        "feature": {"w": kgrads["dw_feature"].T, "b": kgrads["db_feature"][:, 0]},
        "alpha": {"w": kgrads["dw_alpha"][0:1].T, "b": kgrads["db_alpha"][0:1, 0]},
        "views": [{"w": dview, "b": kgrads["db_view"][:, 0]}],
        "rgb": {"w": kgrads["dw_rgb"][0:3].T, "b": kgrads["db_rgb"][0:3, 0]},
    }


def _forward_acts(inputs, meta, pts_t, views_t):
    """The forward in point-major fp32 holding bf16 values: (acts, raw [N, 8])."""
    w = {k: v.float() for k, v in inputs.items()}
    feat = _bf(_encode_ladder(pts_t.T * (1.0 / 10.0), meta["pts_freqs"]))
    venc = _bf(_encode_ladder(views_t.T * 1.0, meta["view_freqs"]))
    hs, h = [], feat
    for i in range(meta["n_layers"]):
        acc = h @ w[f"w{i}"].T
        if i >= 1 and (i - 1) in meta["skips"]:
            acc = acc + feat @ w[f"wskip{i}"].T
        h = _bf(torch.relu(acc + w[f"b{i}"].T))
        hs.append(h)
    feature = _bf(h @ w["w_feature"].T + w["b_feature"].T)
    sigma = h @ w["w_alpha"].T + w["b_alpha"].T
    hv = _bf(torch.relu(feature @ w["w_view_h"].T + venc @ w["w_view_enc"].T + w["b_view"].T))
    rgb = hv @ w["w_rgb"].T + w["b_rgb"].T
    raw = torch.cat([rgb[:, 0:3], sigma[:, 0:1], torch.zeros_like(rgb[:, 0:4])], 1)
    return dict(feat=feat, venc=venc, hs=hs, feature=feature, hv=hv), raw


@torch.no_grad()
def field_forward_plain(inputs, meta, pts_t: torch.Tensor, views_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, same arguments and result as
    `field_forward`."""
    return _forward_acts(inputs, meta, pts_t, views_t)[1].T.contiguous()


@torch.no_grad()
def field_backward_plain(
    inputs, meta, pts_t: torch.Tensor, views_t: torch.Tensor, g_raw: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of K5, written out as `_bwd_kernel`: same
    arguments and result as `field_backward`."""
    acts, _ = _forward_acts(inputs, meta, pts_t, views_t)
    w = {k: v.float() for k, v in inputs.items()}
    feat, venc, hs, feature, hv = (acts[k] for k in ("feat", "venc", "hs", "feature", "hv"))
    g = g_raw.T  # [N, 8]
    zeros = torch.zeros_like(g)
    g_rgb = torch.cat([g[:, 0:3], zeros[:, 0:5]], 1)
    g_sigma = torch.cat([g[:, 3:4], zeros[:, 0:7]], 1)
    out: Dict[str, torch.Tensor] = {}
    rowsum = lambda x: x.sum(0)[:, None]  # noqa: E731

    g_rgb_c = _bf(g_rgb)
    out["dw_rgb"] = g_rgb_c.T @ hv
    out["db_rgb"] = rowsum(g_rgb)
    g_hv = _bf((g_rgb_c @ w["w_rgb"]) * (hv > 0))
    out["dw_view_h"] = g_hv.T @ feature
    out["dw_view_enc"] = g_hv.T @ venc
    out["db_view"] = rowsum(g_hv)
    g_feature = g_hv @ w["w_view_h"]
    g_feature_c = _bf(g_feature)
    h_last = hs[-1]
    out["dw_feature"] = g_feature_c.T @ h_last
    out["db_feature"] = rowsum(g_feature)
    g_sigma_c = _bf(g_sigma)
    out["dw_alpha"] = g_sigma_c.T @ h_last
    out["db_alpha"] = rowsum(g_sigma)
    g_h = g_feature_c @ w["w_feature"] + g_sigma_c @ w["w_alpha"]
    for i in range(meta["n_layers"] - 1, -1, -1):
        g_h = g_h * (hs[i] > 0)
        g_c = _bf(g_h)
        out[f"dw{i}"] = g_c.T @ (feat if i == 0 else hs[i - 1])
        if i >= 1 and (i - 1) in meta["skips"]:
            out[f"dwskip{i}"] = g_c.T @ feat
        out[f"db{i}"] = rowsum(g_h)
        if i > 0:
            g_h = g_c @ w[f"w{i}"]
    return {name: out[name] for name in grad_names(meta)}


def field_meta(spec: NerfMLPSpec) -> Dict[str, Any]:
    """The static meta `build_kernel_inputs` returns, from the spec alone."""
    return dict(
        n_layers=spec.depth,
        skips=tuple(spec.skips),
        pts_freqs=_freqs_from_input_ch(spec.input_ch),
        view_freqs=_freqs_from_input_ch(spec.input_ch_views),
        width=spec.width,
        input_ch=spec.input_ch,
        input_ch_views=spec.input_ch_views,
    )


def _meta_key(meta: Dict[str, Any]) -> tuple:
    return tuple(sorted(meta.items()))


def _check_cuda_inputs(meta, device, **arrays) -> int:
    if device.type != "cuda":
        raise ValueError(f"no fused field kernel for device {device}")
    if _shape(meta) not in KERNEL_SHAPES:
        raise ValueError(
            "the fused field kernels are built for (width, point frequencies, view frequencies) "
            f"in {KERNEL_SHAPES}, got {_shape(meta)}"
        )
    if len(meta["skips"]) > 1 or meta["n_layers"] > KERNEL_MAX_DEPTH:
        raise ValueError("the fused field kernels take at most one skip and 16 layers")
    n = arrays["pts_t"].shape[1]
    for name, t in arrays.items():
        rows = 8 if name == "g_raw" else 3
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {device}")
        if tuple(t.shape) != (rows, n):
            raise ValueError(f"{name} must be [{rows}, {n}], got {tuple(t.shape)}")
    if n < 1:
        raise ValueError("the fused field needs at least one point")
    return n


def _shape(meta) -> Tuple[int, int, int]:
    return meta["width"], meta["pts_freqs"], meta["view_freqs"]


def _library(meta) -> str:
    """The name of the training field library built for the net's shape."""
    return _build.field_library(*_shape(meta))


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros((rows, *w.shape[1:]), dtype=w.dtype, device=w.device)
    out[: w.shape[0]] = w
    return out


def _pad_cols(w: torch.Tensor, cols: int, at: int = 0) -> torch.Tensor:
    out = torch.zeros((w.shape[0], cols), dtype=w.dtype, device=w.device)
    out[:, at : at + w.shape[1]] = w
    return out


def _skip_layer(meta) -> int:
    return meta["skips"][0] + 1 if meta["skips"] else -1


# The kernels' weight stream (csrc/train_field.cu, `field_stream_rows`):
# every product's [rows, K] matrix cut into slabs of 64 bf16 inputs (128
# bytes) a row, K zero-padded to the 16-value k-step, each slab's rows in
# wgmma's 128-byte swizzle.
SLAB_ELEMS = 64
K_STEP_ELEMS = 16


class StreamLayout(NamedTuple):
    """Where one architecture's slabs lie in its packed stream: per table
    (K4's forward, K5's chain) one (name, byte offset, bytes, rows,
    k_bytes) per slab in the order the consumers take them; the stream's
    bf16 count; and the tables as the launch entries' host arrays."""

    forward: tuple
    backward: tuple
    n_elems: int
    c_forward: tuple
    c_backward: tuple


class FieldStream(NamedTuple):
    """One net's packed weights for the field kernels: `buffer` bf16 on the
    device (the forward slabs, then the transposes only the backward
    reads), its `layout`, and the fp32 biases in the launch entries' order
    (b_0 .., b_alpha, b_feature, b_view, b_rgb)."""

    buffer: torch.Tensor
    layout: StreamLayout
    biases: tuple


def _stream_matrices(inputs, meta):
    """(forward, backward) lists of (name, [rows, K] matrix) of kernel-layout
    `inputs`, in the order the kernels' consumers take their slabs: the
    trunk (layer 0's encoding part, each later layer's skip encoding part
    and hidden part), alpha (padded to 16 rows), feature, the view layer's
    feature and view-encoding parts, rgb (16 rows); the backward takes the
    trunk, feature and view matrices, then rgb^T (rgb in columns 0-2 of
    16), view_h^T, feature^T, alpha^T (column 8 of 16) and w_i^T for i = L-1
    .. 1. Inputs without the transposes give an empty backward list."""
    n_layers, skip = meta["n_layers"], _skip_layer(meta)
    trunk = [("w0", inputs["w0"])]
    for i in range(1, n_layers):
        if i == skip:
            trunk.append((f"wskip{i}", inputs[f"wskip{i}"]))
        trunk.append((f"w{i}", inputs[f"w{i}"]))
    view = [(k, inputs[k]) for k in ("w_feature", "w_view_h", "w_view_enc")]
    forward = trunk + [("w_alpha", _pad_rows(inputs["w_alpha"], 16))] + view + [
        ("w_rgb", _pad_rows(inputs["w_rgb"], 16))]
    if "w_feature_t" not in inputs:
        return forward, []
    backward = trunk + view + [
        ("w_rgb_t", _pad_cols(inputs["w_rgb_t"][:, 0:3], 16)),
        ("w_view_h_t", inputs["w_view_h_t"]),
        ("w_feature_t", inputs["w_feature_t"]),
        ("w_alpha_t", _pad_cols(inputs["w_alpha_t"][:, 0:1], 16, _GH_SIGMA)),
    ] + [(f"w{i}_t", inputs[f"w{i}_t"]) for i in range(n_layers - 1, 0, -1)]
    return forward, backward


def _slabs(m: torch.Tensor) -> torch.Tensor:
    """[rows, K] matrix of 2-byte values (or their indices) -> [n_slabs, rows
    * 64] slabs: K zero-padded to a multiple of 64, slab j holding inputs
    [64 j, 64 j + 64) of every row, 16-byte chunk p of row r holding the
    row's chunk p ^ (r % 8) (byte b of row r at r * 128 + (((b >> 4) ^ r) &
    7) * 16 + (b & 15), csrc/hopper.cuh `swz`)."""
    rows, k = m.shape
    n = -(-k // SLAB_ELEMS)
    padded = torch.zeros(rows, n * SLAB_ELEMS, dtype=m.dtype, device=m.device)
    padded[:, :k] = m
    chunks = padded.reshape(rows, n, 8, 8).permute(1, 0, 2, 3)  # [slab, row, chunk, value]
    r = torch.arange(rows, device=m.device)[:, None]
    src = torch.arange(8, device=m.device)[None, :] ^ (r % 8)
    slabs = torch.gather(chunks, 2, src[None, :, :, None].expand(n, rows, 8, 8))
    return slabs.reshape(n, rows * SLAB_ELEMS)


def _pack(inputs, meta):
    """(forward table, backward table, bf16 count, slabs in buffer order) of
    kernel-layout `inputs` (`StreamLayout`'s tables)."""
    forward, backward = _stream_matrices(inputs, meta)
    names = dict(forward)
    entries, parts, off = {}, [], 0
    for name, m in forward + [x for x in backward if x[0] not in names]:
        k_bytes = 2 * -(-m.shape[1] // K_STEP_ELEMS) * K_STEP_ELEMS
        entries[name] = []
        for s in _slabs(m):
            entries[name].append((name, 2 * off, 2 * s.numel(), m.shape[0], k_bytes))
            parts.append(s)
            off += s.numel()
    fwd = tuple(e for name, _ in forward for e in entries[name])
    bwd = tuple(e for name, _ in backward for e in entries[name])
    return fwd, bwd, off, parts


_LAYOUTS: Dict[tuple, StreamLayout] = {}


def _layout(meta, fwd, bwd, n_elems) -> StreamLayout:
    key = _meta_key(meta) + (len(bwd),)
    hit = _LAYOUTS.get(key)
    if hit is None:
        hit = _LAYOUTS[key] = StreamLayout(fwd, bwd, n_elems, _build.slab_arrays(fwd), _build.slab_arrays(bwd))
    return hit


@torch.no_grad()
def pack_field_stream(inputs, meta) -> FieldStream:
    """Pack kernel-layout `inputs` (`build_kernel_inputs`) into the field
    kernels' weight stream (`FieldStream`), slab by slab as
    `_stream_matrices` orders them. The training step packs its leaves into
    the same bytes with one gather (`_FusedField`)."""
    fwd, bwd, n_elems, parts = _pack(inputs, meta)
    buffer = torch.cat(parts).to(torch.bfloat16)
    vec = lambda b: b.reshape(-1)  # noqa: E731
    biases = tuple(vec(inputs[f"b{i}"]) for i in range(meta["n_layers"])) + tuple(
        vec(inputs[k]) for k in ("b_alpha", "b_feature", "b_view", "b_rgb"))
    return FieldStream(buffer, _layout(meta, fwd, bwd, n_elems), biases)


_LEAF_INDEX: Dict[tuple, tuple] = {}


def _leaf_indices(template, spec: NerfMLPSpec, meta, device: torch.device):
    """(stream index, gradient index, layout) of one architecture on
    `device`, built on the CPU once and copied to each device.

    The stream index gives, for each bf16 of the packed stream, 1 + its
    position in the concatenated flattened leaves (0: a zero pad), so that
    `cat([0, leaves]).index_select(stream index)` cast to bf16 equals
    `pack_field_stream(build_kernel_inputs(params))` value for value (its
    masked pads may hold -0 where this holds +0). It comes
    from `build_kernel_inputs` itself, run on trees holding the positions'
    base-256 digits (its bf16 cast is exact on integers below 256). The
    gradient index gives, for each leaf gradient value, its position in
    the kernel's [dW, db] buffer: `grads_to_tree` of `_split_grads` run on
    the positions."""
    key = _meta_key(meta) + (str(device),)
    hit = _LEAF_INDEX.get(key)
    if hit is not None:
        return hit
    if device.type != "cpu":
        # Built once on the CPU, copied to each device.
        stream_index, grad_index, layout = _leaf_indices(template, spec, meta, torch.device("cpu"))
        hit = _LEAF_INDEX[key] = (stream_index.to(device), grad_index.to(device), layout)
        return hit
    shapes = [tuple(x.shape) for x in tree_leaves(template)]
    sizes = [int(np.prod(s)) for s in shapes]
    total = sum(sizes)
    if total >= 1 << 24:
        raise ValueError(f"{total} parameters: the stream index takes fewer than 2**24")
    pos = torch.arange(1, total + 1, dtype=torch.int64)
    combined: Dict[str, torch.Tensor] = {}
    for k in range(3):
        digit = ((pos >> (8 * k)) & 255).to(torch.float32)
        tree = tree_unflatten(template, [x.view(s) for x, s in zip(digit.split(sizes), shapes)])
        inputs, _ = build_kernel_inputs(tree, spec)
        for name, t in inputs.items():
            if name.startswith("w"):
                combined[name] = combined.get(name, 0) + (t.to(torch.int64) << (8 * k))
    fwd, bwd, n_elems, parts = _pack(combined, meta)
    stream_index = torch.cat(parts)
    shapes_g = grad_shapes(meta)
    n_dw = sum(int(np.prod(s)) for name, s in shapes_g.items() if name.startswith("dw"))
    n_db = sum(s[0] for name, s in shapes_g.items() if name.startswith("db"))
    flat = torch.arange(n_dw + n_db, dtype=torch.float64)
    tree = grads_to_tree(_split_grads(meta, flat[:n_dw], flat[n_dw:]), meta)
    grad_index = torch.cat([x.reshape(-1) for x in tree_leaves(tree)]).to(torch.int64)
    hit = _LEAF_INDEX[key] = (stream_index, grad_index, _layout(meta, fwd, bwd, n_elems))
    return hit


def _pack_leaves(params, leaves, spec, meta):
    """The training step's pack: the net's leaves -> (`FieldStream`,
    gradient index), three device operations and no host-to-device copy
    (after the first call of an architecture), so a CUDA graph can hold it."""
    device = leaves[0].device
    stream_index, grad_index, layout = _leaf_indices(params, spec, meta, device)
    flat = torch.cat([leaves[0].new_zeros(1), *[x.reshape(-1) for x in leaves]])
    buffer = flat.index_select(0, stream_index).to(torch.bfloat16)
    biases = tuple(layer["b"] for layer in params["pts"]) + (
        params["alpha"]["b"], params["feature"]["b"], params["views"][0]["b"], params["rgb"]["b"])
    return FieldStream(buffer, layout, biases), grad_index


def _launch_args(ws: FieldStream, meta, device, backward: bool) -> tuple:
    """The arguments both launch entries take first: (biases array, depth,
    skip layer, buffer pointer, slab offsets, slab bytes, slab count)."""
    table = ws.layout.backward if backward else ws.layout.forward
    if backward and not table:
        raise ValueError("the stream holds no backward table (inputs without the transposes)")
    buf = ws.buffer
    if buf.dtype != torch.bfloat16 or buf.device != device or buf.data_ptr() % 128:
        raise ValueError(f"the weight stream must be 128-byte aligned bf16 on {device}")
    for b in ws.biases:
        if b.dtype != torch.float32 or b.device != device or not b.is_contiguous() or b.data_ptr() % 8:
            raise ValueError(f"field biases must be contiguous 8-byte aligned float32 on {device}")
    offs, sizes = ws.layout.c_backward if backward else ws.layout.c_forward
    biases = (ctypes.c_void_p * len(ws.biases))(*[b.data_ptr() for b in ws.biases])
    return biases, meta["n_layers"], _skip_layer(meta), buf.data_ptr(), offs, sizes, len(table)


def field_forward_packed(ws: FieldStream, meta, pts_t: torch.Tensor, views_t: torch.Tensor) -> torch.Tensor:
    """K4 on a packed stream: points and view directions [3, N] fp32 on the
    card -> raw [8, N] fp32 (rows 0-2 rgb logits, 3 sigma, 4-7 zero)."""
    device = pts_t.device
    n = _check_cuda_inputs(meta, device, pts_t=pts_t, views_t=views_t)
    args = _launch_args(ws, meta, device, backward=False)
    out = torch.empty((8, n), dtype=torch.float32, device=device)
    lib = _library(meta)
    _build.launch(lib, "field_forward_launch", *args, pts_t.data_ptr(), views_t.data_ptr(), out.data_ptr(), n,
                  _build.stream_handle(device))
    LAUNCHES["forward"] += 1
    SHAPE_LAUNCHES[lib]["forward"] += 1
    return out


def _backward_sizes(meta, n: int) -> Tuple[int, int, int]:
    """K5's element counts for n points: (bf16 scratch, dW, db)."""
    sizes = [ctypes.c_longlong() for _ in range(3)]
    _build.launch(_library(meta), "field_backward_sizes", meta["n_layers"], _skip_layer(meta), n,
                  *[ctypes.byref(s) for s in sizes])
    return tuple(int(s.value) for s in sizes)


def _split_grads(meta, dw: torch.Tensor, db: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The kernel's flat dW and db buffers -> named kernel-layout views. dW in
    `grad_names` order; db as db_0.., db_feature, db_alpha, db_view, db_rgb."""
    shapes = grad_shapes(meta)
    names = grad_names(meta)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name in (n for n in names if n.startswith("dw")):
        size = int(np.prod(shapes[name]))
        out[name] = dw[off : off + size].view(shapes[name])
        off += size
    db_order = [f"db{i}" for i in range(meta["n_layers"])] + [
        "db_feature", "db_alpha", "db_view", "db_rgb"]
    off = 0
    for name in db_order:
        size = shapes[name][0]
        out[name] = db[off : off + size].view(size, 1)
        off += size
    return {name: out[name] for name in names}


def _field_backward_flat(ws: FieldStream, meta, pts_t, views_t, g_raw) -> Tuple[torch.Tensor, int]:
    """K5's launches; returns ([dW, db] fp32 in the kernel's order, dW count)."""
    device = pts_t.device
    n = _check_cuda_inputs(meta, device, pts_t=pts_t, views_t=views_t, g_raw=g_raw)
    args = _launch_args(ws, meta, device, backward=True)
    n_scratch, n_dw, n_db = _backward_sizes(meta, n)
    shapes = grad_shapes(meta)
    expect_dw = sum(int(np.prod(s)) for k, s in shapes.items() if k.startswith("dw"))
    expect_db = sum(s[0] for k, s in shapes.items() if k.startswith("db"))
    if (n_dw, n_db) != (expect_dw, expect_db):
        raise RuntimeError(f"kernel gradient layout {n_dw}/{n_db}, expected {expect_dw}/{expect_db}")
    n_tiles, n_chunks = -(-n // 128), -(-n // DW_CHUNK)
    scratch = torch.empty((n_scratch,), dtype=torch.bfloat16, device=device)
    dbpart = torch.empty((2 * n_tiles, n_db), dtype=torch.float32, device=device)
    part = torch.empty((n_chunks, n_dw), dtype=torch.float32, device=device)
    grads = torch.empty((n_dw + n_db,), dtype=torch.float32, device=device)
    lib = _library(meta)
    _build.launch(lib, "field_backward_launch", *args, pts_t.data_ptr(), views_t.data_ptr(), g_raw.data_ptr(),
                  scratch.data_ptr(), dbpart.data_ptr(), part.data_ptr(), grads.data_ptr(),
                  grads.data_ptr() + 4 * n_dw, n, DW_CHUNK, _build.stream_handle(device))
    LAUNCHES["backward"] += 1
    LAUNCHES["backward_kernels"] += BACKWARD_KERNELS
    SHAPE_LAUNCHES[lib]["backward"] += 1
    return grads, n_dw


def field_backward_packed(ws: FieldStream, meta, pts_t, views_t, g_raw) -> Dict[str, torch.Tensor]:
    """K5 on a packed stream: the cotangent of raw [8, N] fp32 on the card ->
    every kernel-layout weight and bias gradient (`grad_names`)."""
    grads, n_dw = _field_backward_flat(ws, meta, pts_t, views_t, g_raw)
    return _split_grads(meta, grads[:n_dw], grads[n_dw:])


def field_forward(inputs, meta, pts_t: torch.Tensor, views_t: torch.Tensor) -> torch.Tensor:
    """K4: points and view directions [3, N] fp32 -> raw [8, N] fp32 (rows
    0-2 rgb logits, 3 sigma, 4-7 zero). Packs `inputs` and launches the
    kernel for CUDA tensors, runs `field_forward_plain` for CPU tensors."""
    if pts_t.device.type == "cpu":
        return field_forward_plain(inputs, meta, pts_t, views_t)
    return field_forward_packed(pack_field_stream(inputs, meta), meta, pts_t, views_t)


def field_backward(
    inputs, meta, pts_t: torch.Tensor, views_t: torch.Tensor, g_raw: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """K5: the cotangent of raw [8, N] fp32 -> every kernel-layout weight and
    bias gradient (names and shapes of `grad_names`/`grad_shapes`), fp32.
    Packs `inputs` and launches the kernels for CUDA tensors (two launches
    on the same inputs give the same bits), runs `field_backward_plain` for
    CPU tensors."""
    if pts_t.device.type == "cpu":
        return field_backward_plain(inputs, meta, pts_t, views_t, g_raw)
    return field_backward_packed(pack_field_stream(inputs, meta), meta, pts_t, views_t, g_raw)


class _FusedField(torch.autograd.Function):
    """raw [N, 4] = field(tree leaves; pts, viewdirs), gradients to the
    leaves only. On the card the leaves are packed into the kernels' stream
    once per call (`_pack_leaves`) and the kernel's gradient buffer is
    gathered back into leaf order; on the CPU the plain versions run on
    `build_kernel_inputs`."""

    @staticmethod
    def forward(ctx, template, spec, pts, viewdirs, *leaves):
        params = tree_unflatten(template, list(leaves))
        pts_t = pts.detach().T.to(torch.float32).contiguous()
        views_t = viewdirs.detach().T.to(torch.float32).contiguous()
        ctx.ws = None
        if pts.device.type == "cpu":
            inputs, meta = build_kernel_inputs(params, spec, with_transposed=False)
            raw_t = field_forward_plain(inputs, meta, pts_t, views_t)
        else:
            meta = field_meta(spec)
            ctx.ws, ctx.grad_index = _pack_leaves(params, leaves, spec, meta)
            raw_t = field_forward_packed(ctx.ws, meta, pts_t, views_t)
        ctx.template, ctx.spec, ctx.meta = template, spec, meta
        ctx.save_for_backward(pts_t, views_t, *leaves)
        return raw_t[:4].T

    @staticmethod
    def backward(ctx, g):
        pts_t, views_t, *leaves = ctx.saved_tensors
        g_raw = torch.cat([g.T.to(torch.float32), torch.zeros_like(g.T)], 0).contiguous()
        if ctx.ws is None:
            params = tree_unflatten(ctx.template, leaves)
            inputs, meta = build_kernel_inputs(params, ctx.spec)
            kgrads = field_backward_plain(inputs, meta, pts_t, views_t, g_raw)
            grads = tree_leaves(grads_to_tree(kgrads, meta))
        else:
            flat, _ = _field_backward_flat(ctx.ws, ctx.meta, pts_t, views_t, g_raw)
            flat = flat.index_select(0, ctx.grad_index)
            grads = [x.view(p.shape) for x, p in zip(flat.split([p.numel() for p in leaves]), leaves)]
        zero = lambda i, t: torch.zeros_like(t.T) if ctx.needs_input_grad[i] else None  # noqa: E731
        return (None, None, zero(2, pts_t), zero(3, views_t), *grads)


def fused_field(
    params: Dict[str, Any], spec: NerfMLPSpec, pts: torch.Tensor, viewdirs: torch.Tensor
) -> torch.Tensor:
    """Encode + MLP of points [N, 3] with per-point view directions [N, 3] ->
    raw [N, 4] (rgb logits, sigma), through K4 forward and K5 backward (their
    plain versions on the CPU). Gradients reach the tree's leaves; points and
    view directions get zero cotangents."""
    if not spec.use_view_dirs:
        raise ValueError("the fused field takes view-dirs models")
    leaves = tree_leaves(params)
    return _FusedField.apply(params, spec, pts, viewdirs, *leaves)
