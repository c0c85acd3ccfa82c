"""The fused inference path: encoding + MLP + volume compositing per pass.

Counterpart of `nerf_workspaces_explorer_tpu/ops/pallas_render.py`:
`render_rays_fused` runs the coarse or proposal pass density-only, places
the fine samples (`ops/importance_merge.py`), then runs the fine pass with
all heads, compositing on the fly so that raw rgba never reaches device
memory; `render_rays_single_pass` is the one-net preview pass.

`nerf_render` launches the CUDA kernel `csrc/fused_render.cu` for CUDA
tensors and runs `nerf_render_plain` for CPU tensors. Both compute what the
TPU kernel computes: the point encoding from per-ray phase vectors (one
polynomial sin/cos per coordinate and octave doubling for the higher
frequencies, rows in kernel order [identity | sin | cos | pad]), the skip
concat and the view concat folded into sums of two products, the view
encoding's product once per ray, and front-to-back compositing with running
transmittance; in one of three modes (`KernelParams.mode`): bf16 operands
with fp32 accumulation and bf16 activations, an int8 trunk with integer
requantization and bf16 heads ("int8-trunk"), or int8 trunk and heads
("int8"). Arrays at this module's functions keep the JAX package's
ray-minor layout ([features, rays]), so the two compare like with like.
"""

from __future__ import annotations

import ctypes
import functools
import math
import warnings
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.obs import profiler
from nerf_workspaces_explorer_tpu_torch.obs.profiler import span
from nerf_workspaces_explorer_tpu_torch.ops import _build
from nerf_workspaces_explorer_tpu_torch.ops.importance_merge import importance_merge
from nerf_workspaces_explorer_tpu_torch.ops.quantize import as_float32_array
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings
from nerf_workspaces_explorer_tpu_torch.render.volume import exclusive_cumprod

PTS_FREQS = 10
VIEW_FREQS = 4

# Kernel launches made by `nerf_render`, by pass and mode: the density pass
# (coarse or proposal) and the full pass, bf16 (K1, K3) or int8 (K7).
LAUNCHES = {
    f"{p}{m}": 0 for p in ("density_only", "full") for m in ("", "_int8_trunk", "_int8")
}

# The kernel's block geometry: a block owns STEP_RAYS rays and evaluates
# STEP_SAMPLES samples of each per step; `live_groups` counts such steps, of
# STEP_POINTS points each.
STEP_RAYS = 32
STEP_SAMPLES = 4
STEP_POINTS = STEP_RAYS * STEP_SAMPLES

# The weight stream's slabs (`pack_weight_stream`): 128 bytes of product depth
# a row, the k-step 32 bytes.
SLAB_ROW_BYTES = 128
K_STEP_BYTES = 32

# Rays per step of the plain version (bounds its activations to ~1 GB at
# 192 samples per ray).
PLAIN_RAY_CHUNK = 4096

KERNEL_MAX_DEPTH = 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _freqs_from_input_ch(input_ch: int) -> int:
    """input_ch = 3 * (1 + 2F) (reference embedding.py:24-38)."""
    if (input_ch - 3) % 6:
        raise ValueError(f"bad encoded input width {input_ch}")
    return (input_ch - 3) // 6


def _enc_dim(num_freqs: int) -> int:
    return _round_up(3 + 6 * num_freqs, 8)


def _phase_scales(num_freqs: int, enc_dim: int, scalar_factor: float) -> np.ndarray:
    """[3, enc_dim]: row c spreads coord c to its identity/sin/cos rows."""
    f = np.zeros((3, enc_dim), dtype=np.float32)
    for c in range(3):
        f[c, c] = 1.0 / scalar_factor
        for k in range(num_freqs):
            f[c, 3 + 3 * k + c] = (2.0**k) / scalar_factor
            f[c, 3 + 3 * num_freqs + 3 * k + c] = (2.0**k) / scalar_factor
    return f


def _cos_bias(num_freqs: int, enc_dim: int) -> np.ndarray:
    """[enc_dim] +pi/2 on the cos rows (sin(x + pi/2) = cos(x))."""
    b = np.zeros((enc_dim,), dtype=np.float32)
    b[3 + 3 * num_freqs : 3 + 6 * num_freqs] = np.pi / 2.0
    return b


def _encoding_permutation(num_freqs: int, enc_dim: int) -> np.ndarray:
    """kernel_row -> reference_row map (-1 = zero pad). The reference order
    interleaves [sin_f xyz, cos_f xyz] per frequency; the kernel order groups
    all sin rows, then all cos rows."""
    perm = np.full((enc_dim,), -1, dtype=np.int64)
    perm[0:3] = [0, 1, 2]
    for k in range(num_freqs):
        for c in range(3):
            perm[3 + 3 * k + c] = 3 + 6 * k + c
            perm[3 + 3 * num_freqs + 3 * k + c] = 6 + 6 * k + c
    return perm


def _permute_pad_in_rows(w: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """Reorder the input-side rows of an [in, out] weight to kernel order."""
    out = w[torch.as_tensor(np.maximum(perm, 0), device=w.device)]
    return out * torch.as_tensor(perm >= 0, dtype=w.dtype, device=w.device)[:, None]


MODE_BF16, MODE_INT8_TRUNK, MODE_INT8 = 0, 1, 2  # KernelParams.mode


class KernelParams(NamedTuple):
    """One network's weights in kernel layout (the JAX package's
    KernelParams): weights [out, in], biases [out].

    bf16 mode: bf16 weights, fp32 biases. With `shift_layers` non-empty the
    trunk is int8 (`ops/quantize.py`): int8 weights, int32 biases with the
    rounding offset folded in, and the power-of-2 requant shifts; the heads
    stay bf16, with the trunk's last real scale folded into them
    ("int8-trunk"), unless `int8_heads` ("int8"): then the fa, view and rgb
    weights are int8 too and only sigma and rgb dequantize, through s_alpha
    and s_rgb."""

    w_layers: tuple  # depth x [width, in]
    w_skip_enc: tuple  # per skip layer [width, pts enc dim]
    b_layers: tuple  # depth x [width]
    w_fa: torch.Tensor  # [fa_rows, width]: rows 0..width-1 feature, row width alpha
    b_fa: torch.Tensor  # [fa_rows]
    w_view_h: torch.Tensor  # [width // 2, width]
    w_view_enc: torch.Tensor  # [width // 2, view enc dim]
    b_view: torch.Tensor  # [width // 2]
    w_rgb: torch.Tensor  # [16, width // 2], rows 0-2 live
    b_rgb: torch.Tensor  # [16]
    skips: tuple
    width: int = 256
    pts_freqs: int = PTS_FREQS
    view_freqs: int = VIEW_FREQS
    shift_layers: tuple = ()  # int8 trunk: per-layer requant shift
    skip_shift: tuple = ()  # int8 trunk: per-skip scale-match shift
    feat_qscale: Optional[float] = None  # int8 trunk: encoding quant scale
    int8_heads: bool = False
    k_feat: int = 0  # feature head requant shift (signed clip)
    k_hv: int = 0  # view layer requant shift
    s_alpha: float = 1.0  # sigma accumulator -> fp32
    inv_s_view: float = 1.0  # 1 / view accumulator scale
    s_rgb: float = 1.0  # rgb accumulator -> fp32

    @property
    def mode(self) -> int:
        """The kernel's mode: 0 bf16, 1 int8 trunk, 2 int8 trunk and heads."""
        if not self.shift_layers:
            return MODE_BF16
        return MODE_INT8 if self.int8_heads else MODE_INT8_TRUNK


def _balanced_requant(w_unit: float, in_unit: float, target: float) -> Tuple[float, int]:
    """The requant shift k and the (possibly inflated) weight unit that put
    the post-shift activation unit raw * 2^k (raw = w_unit * in_unit) as
    close above the calibrated target as int8 weights and right shifts
    allow: floor k and absorb the residual factor into the weight unit when
    the ceil's overshoot would exceed sqrt(2), so at most sqrt(2)x of
    resolution is lost per requant stage (JAX pallas_render.py:168-194).
    Returns (w_unit, k)."""
    t = target / (w_unit * in_unit)
    if t <= 1.0:
        # The accumulator is already coarser than the target unit.
        return w_unit, 0
    k = math.floor(math.log2(t))
    s = t / 2.0**k  # overshoot of the floored shift, in [1, 2)
    if s <= math.sqrt(2.0):
        return w_unit * s, k
    return w_unit, k + 1


def _quantize_w(w_t: np.ndarray, unit: float) -> np.ndarray:
    """Per-tensor symmetric int8: clip(round(w / unit), -127, 127), the
    division in fp32 as the JAX package does it."""
    return np.clip(np.round(w_t / np.float32(unit)), -127, 127).astype(np.int8)


def _quantize_b(b: np.ndarray, unit: float, k: int = 0) -> np.ndarray:
    """int32 bias round(b / unit), plus 2^(k-1) (the requant's rounding
    offset) when a shift k > 0 follows."""
    q = np.round(b / np.float32(unit)).astype(np.int32)
    return q + np.int32(1 << (k - 1)) if k > 0 else q


def prepare_kernel_params(
    params: Dict[str, Any],
    spec: Optional[NerfMLPSpec] = None,
    quant=None,
) -> KernelParams:
    """One network's [in, out] parameter tree -> kernel layout on the device
    of the tree's weights, as the JAX package's `prepare_kernel_params`
    (pallas_render.py:197-432). With `quant` (an `ops.quantize.TrunkQuant`)
    the trunk quantizes to int8 with power-of-2 requantization, and with its
    head fields the heads too. The arithmetic runs in numpy fp32, so both
    packages give the same int8 weights, int32 biases and shifts."""
    spec = spec or NerfMLPSpec()
    if not spec.use_view_dirs or spec.width % 16:
        raise ValueError("the fused path takes view-dirs models of width divisible by 16")
    w0 = params["pts"][0]["w"]
    device = w0.device if isinstance(w0, torch.Tensor) else torch.device("cpu")
    pts_freqs = _freqs_from_input_ch(spec.input_ch)
    view_freqs = _freqs_from_input_ch(spec.input_ch_views)
    pts_perm = _encoding_permutation(pts_freqs, _enc_dim(pts_freqs))
    view_perm = _encoding_permutation(view_freqs, _enc_dim(view_freqs))
    width = spec.width
    fa_rows = _round_up(width + 8, 128)
    n_layers = len(params["pts"])
    int8_heads = bool(quant is not None and quant.int8_heads)
    feat_qscale = 127.0 / quant.feat_max if quant is not None else None
    shift_layers, skip_shift = [], []
    a_last = 1.0  # int8-trunk: the last trunk layer's real scale, folded into the heads
    h_unit = None  # running activation quant unit

    w_layers, w_skip_enc, b_layers = [], [], []
    for i, layer in enumerate(params["pts"]):
        w, b = as_float32_array(layer["w"]), as_float32_array(layer["b"])  # [in, out], [out]
        w_skip_t = None
        if i == 0:
            w_t = _permute_pad_in_rows(torch.tensor(w), pts_perm).numpy().T
        elif (i - 1) in spec.skips:
            # Concat order [input_pts, h] (reference nerf_model.py:59).
            w_skip_t = _permute_pad_in_rows(torch.tensor(w[: spec.input_ch]), pts_perm).numpy().T
            w_t = w[spec.input_ch :].T
        else:
            w_t = w.T
        if quant is None:
            if w_skip_t is not None:
                w_skip_enc.append(w_skip_t)
            w_layers.append(w_t)
            b_layers.append(b)
            continue

        # The accumulator's real scale is raw = w_unit * in_unit; the next
        # activation's unit is raw * 2^k, so the epilogue is integer-only:
        # clip((acc + b_i32) >> k, 0, 127).
        feat_unit = quant.feat_max / 127.0
        in_unit = feat_unit if i == 0 else h_unit
        w_unit = quant.w_max[i] / 127.0
        k = None
        if i < n_layers - 1 or int8_heads:
            target = (quant.h_max[i] if i < n_layers - 1 else quant.h_last_max) / 127.0
            if target <= 0.0:
                # A layer dead on the calibration batch: anchor its unit at
                # the encoding's, so the downstream requants stay in range
                # (k = 0 would push the skip-match shift far below -8).
                target = quant.feat_max / 127.0
            w_unit, k = _balanced_requant(w_unit, in_unit, target)
        raw = w_unit * in_unit
        if w_skip_t is not None:
            # Match the skip product's scale to raw with a power-of-2 shift
            # j (floored, so no skip weight clips); negative j left-shifts,
            # clamped at -8 to keep 8 bits of int32 headroom.
            skip_ideal = quant.skip_w_max[len(w_skip_enc)] / 127.0 * feat_unit
            j_raw = math.floor(math.log2(raw / skip_ideal))
            if j_raw < -8:
                warnings.warn(
                    f"int8 calibration out of range for skip layer {len(w_skip_enc)}: needs "
                    f"shift {j_raw} < -8; skip weights will saturate - use bf16/parity "
                    "precision for this checkpoint",
                    RuntimeWarning,
                    stacklevel=2,
                )
            j = max(-8, j_raw)
            skip_shift.append(j)
            w_skip_enc.append(_quantize_w(w_skip_t, raw / (2.0**j) / feat_unit))
        if k is not None:
            h_unit = raw * (2.0**k)
            shift_layers.append(k)
            b_layers.append(_quantize_b(b, raw, k))
        else:
            shift_layers.append(0)
            a_last = raw
            b_layers.append(_quantize_b(b, raw))
        w_layers.append(_quantize_w(w_t, w_unit))

    w_fa = np.zeros((fa_rows, width), dtype=np.float32)
    w_fa[:width] = as_float32_array(params["feature"]["w"]).T
    w_fa[width] = as_float32_array(params["alpha"]["w"])[:, 0]
    # int8-trunk: the trunk's last activations arrive in the integer domain;
    # their real scale rides in the head weights (1.0 otherwise).
    w_fa = w_fa * np.float32(a_last) if a_last != 1.0 else w_fa
    b_fa = np.zeros((fa_rows,), dtype=np.float32)
    b_fa[:width] = as_float32_array(params["feature"]["b"])
    b_fa[width] = as_float32_array(params["alpha"]["b"])[0]

    w_view = as_float32_array(params["views"][0]["w"])  # [width + view_in, width // 2]
    w_view_h = np.ascontiguousarray(w_view[:width].T)
    w_view_enc = _permute_pad_in_rows(torch.tensor(w_view[width:]), view_perm).numpy().T
    b_view = as_float32_array(params["views"][0]["b"])
    w_rgb = np.zeros((16, width // 2), dtype=np.float32)
    w_rgb[:3] = as_float32_array(params["rgb"]["w"]).T
    b_rgb = np.zeros((16,), dtype=np.float32)
    b_rgb[:3] = as_float32_array(params["rgb"]["b"])

    k_feat = k_hv = 0
    s_alpha = inv_s_view = s_rgb = 1.0
    if int8_heads:
        # The scale chain continues through the heads: fa, view and rgb are
        # int8 products; only sigma and rgb dequantize; the per-ray view
        # term moves to the view accumulator's integer domain once per ray.
        u_feat_w, k_feat = _balanced_requant(
            quant.w_feat_max / 127.0, h_unit, quant.feature_max / 127.0
        )
        u_alpha_w = quant.w_alpha_max / 127.0
        s_feat_acc = u_feat_w * h_unit
        s_alpha = u_alpha_w * h_unit
        w_fa_q = np.zeros((fa_rows, width), dtype=np.int8)
        w_fa_q[:width] = _quantize_w(w_fa[:width], u_feat_w)
        w_fa_q[width] = _quantize_w(w_fa[width : width + 1], u_alpha_w)[0]
        b_fa_q = np.zeros((fa_rows,), dtype=np.int32)
        b_fa_q[:width] = _quantize_b(b_fa[:width], s_feat_acc, k_feat)
        b_fa_q[width] = _quantize_b(b_fa[width : width + 1], s_alpha)[0]
        w_fa, b_fa = w_fa_q, b_fa_q
        feat_unit = s_feat_acc * (2.0**k_feat)
        u_vh_w, k_hv = _balanced_requant(quant.w_view_h_max / 127.0, feat_unit, quant.hv_max / 127.0)
        s_view_acc = u_vh_w * feat_unit
        inv_s_view = 1.0 / s_view_acc
        w_view_h = _quantize_w(w_view_h, u_vh_w)
        u_rgb_w = quant.w_rgb_max / 127.0
        hv_unit = s_view_acc * (2.0**k_hv)
        w_rgb = _quantize_w(w_rgb, u_rgb_w)
        s_rgb = u_rgb_w * hv_unit

    def put(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """To `device` as `dtype`: float arrays round to bf16 there, int8 and
        int32 arrays keep their integers."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype == torch.bfloat16:
            t = t.to(torch.bfloat16)
        return t.to(device=device, dtype=dtype).contiguous()

    trunk_w = torch.int8 if quant is not None else torch.bfloat16
    trunk_b = torch.int32 if quant is not None else torch.float32
    head_w = torch.int8 if int8_heads else torch.bfloat16
    return KernelParams(
        w_layers=tuple(put(w, trunk_w) for w in w_layers),
        w_skip_enc=tuple(put(w, trunk_w) for w in w_skip_enc),
        b_layers=tuple(put(b, trunk_b) for b in b_layers),
        w_fa=put(w_fa, head_w),
        b_fa=put(b_fa, torch.int32 if int8_heads else torch.float32),
        w_view_h=put(w_view_h, head_w),
        w_view_enc=put(w_view_enc, torch.bfloat16),
        b_view=put(b_view, torch.float32),
        w_rgb=put(w_rgb, head_w),
        b_rgb=put(b_rgb, torch.float32),
        skips=tuple(spec.skips),
        width=width,
        pts_freqs=pts_freqs,
        view_freqs=view_freqs,
        shift_layers=tuple(shift_layers),
        skip_shift=tuple(skip_shift),
        feat_qscale=feat_qscale,
        int8_heads=int8_heads,
        k_feat=k_feat,
        k_hv=k_hv,
        s_alpha=s_alpha,
        inv_s_view=inv_s_view,
        s_rgb=s_rgb,
    )


@functools.lru_cache(maxsize=None)
def _encoding_constants(num_freqs: int, scalar_factor: float, device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_phase_scales` [3, enc_dim] and `_cos_bias` [enc_dim] on `device`,
    copied there once: an encoding then copies nothing from the host, which
    on the card would wait for the stream and cannot be captured in a CUDA
    graph. Read-only."""
    enc_dim = _enc_dim(num_freqs)
    return (torch.as_tensor(_phase_scales(num_freqs, enc_dim, scalar_factor), device=device),
            torch.as_tensor(_cos_bias(num_freqs, enc_dim), device=device))


def ray_phase_vectors(
    origins: torch.Tensor, dirs: torch.Tensor, num_freqs: int = PTS_FREQS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray phase offset/slope [enc_dim, R] each, so that sample z's
    encoding phases are `o_ph + z * d_ph` (cos pi/2 bias folded into o_ph).
    The kernels read rows 0-2, the base phases coord / 10."""
    scales, bias = _encoding_constants(num_freqs, 10.0, origins.device)
    # Each column of `scales` has one nonzero entry, so these sums are exact
    # (a matmul could take a TF32 path on the card).
    o_ph = (origins[:, :, None] * scales).sum(1) + bias
    d_ph = (dirs[:, :, None] * scales).sum(1)
    return o_ph.T.contiguous(), d_ph.T.contiguous()


def encode_viewdirs_kernel_order(
    viewdirs: torch.Tensor, num_freqs: int = VIEW_FREQS
) -> torch.Tensor:
    """Per-ray view encoding in kernel row order -> [enc_dim, R] bf16."""
    enc_dim = _enc_dim(num_freqs)
    scales, bias = _encoding_constants(num_freqs, 1.0, viewdirs.device)
    phases = (viewdirs[:, :, None] * scales).sum(1) + bias
    row = torch.arange(enc_dim, device=viewdirs.device)
    feat = torch.where(
        row < 3, phases, torch.where(row < 3 + 6 * num_freqs, torch.sin(phases), 0.0)
    )
    return feat.T.to(torch.bfloat16).contiguous()


# Quadrant-reduced polynomial sin/cos (cephes sinf/cosf coefficients on
# [-pi/4, pi/4]; Cody-Waite two-term pi/2 split for the reduction).
_SIN_C = (-1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4)
_COS_C = (-0.5, 4.166664568298827e-2, -1.388731625493765e-3, 2.443315711809948e-5)
_PIO2_HI = 1.5707855224609375
_PIO2_LO = math.pi / 2.0 - _PIO2_HI


def _sincos_poly(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin(p), cos(p) in fp32 from one quadrant reduction and two short
    polynomials (max abs error ~8e-8 for |p| <= 4)."""
    q = torch.round(p * (2.0 / math.pi))  # round half to even, as jnp.round
    r = (p - q * _PIO2_HI) - q * _PIO2_LO
    r2 = r * r
    s0 = r + r * r2 * (_SIN_C[0] + r2 * (_SIN_C[1] + r2 * _SIN_C[2]))
    c0 = 1.0 + r2 * (_COS_C[0] + r2 * (_COS_C[1] + r2 * (_COS_C[2] + r2 * _COS_C[3])))
    qi = q.to(torch.int32)
    swap = (qi & 1) == 1
    s = torch.where(swap, c0, s0)
    c = torch.where(swap, -s0, c0)
    sign = torch.where((qi & 2) == 2, -1.0, 1.0)
    return s * sign, c * sign


def _encode_ladder(p: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[..., 3] base phases -> [..., enc_dim] fp32 features in kernel order:
    one sin/cos pair on the base phases, then octave doubling
    (sin 2x = 2 sin x cos x, cos 2x = 1 - 2 sin^2 x)."""
    s, c = _sincos_poly(p)
    sin_rows, cos_rows = [s], [c]
    for _ in range(num_freqs - 1):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        sin_rows.append(s)
        cos_rows.append(c)
    rows = [p] + sin_rows + cos_rows
    pad = _enc_dim(num_freqs) - (3 + 6 * num_freqs)
    if pad:
        rows.append(torch.zeros(*p.shape[:-1], pad, dtype=p.dtype, device=p.device))
    return torch.cat(rows, -1)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in fp32: products of bf16 values are exact
    in fp32, so `_bf(a) @ _bf(b)` is a bf16 product with fp32 accumulation."""
    return x.to(torch.bfloat16).to(torch.float32)


def _int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product a @ w.T of int8-valued operands -> int32.

    PyTorch has no int32 matmul on the card (nor int8 on the CPU), so the
    product runs in float64: every partial sum of int8 x int8 terms is an
    integer below 2^53 (at most 320 x 127 x 127 here), so any summation
    order gives the exact result."""
    return (a.to(torch.float64) @ w.to(torch.float64).T).to(torch.int32)


def _shift(x: torch.Tensor, j: int) -> torch.Tensor:
    """x >> j for j >= 0, x << -j otherwise (arithmetic, int32)."""
    return x >> j if j >= 0 else x << -j


def _quantize_feat(feat: torch.Tensor, qscale: float) -> torch.Tensor:
    """clip(round(feat * qscale), -127, 127), round half to even, in fp32."""
    return torch.clamp(torch.round(feat * qscale), -127.0, 127.0).to(torch.int32)


def _trunk_plain(kp: KernelParams, feat: torch.Tensor) -> torch.Tensor:
    """The density trunk of `nerf_render_plain` on encoded points [..., enc]
    (bf16-valued fp32, or int8-valued int32 in the int8 modes) -> the last
    activations: bf16-valued fp32 (bf16, int8-trunk) or int8-valued int32
    (int8)."""
    int8 = kp.mode != MODE_BF16
    w_skip = kp.w_skip_enc if int8 else [w.float() for w in kp.w_skip_enc]
    h, skip_i = feat, 0
    for i, w in enumerate(kp.w_layers):
        skip = i > 0 and (i - 1) in kp.skips
        if not int8:
            acc = h @ w.float().T
            if skip:
                acc = acc + feat @ w_skip[skip_i].T
                skip_i += 1
            h = _bf(torch.relu(acc + kp.b_layers[i]))
            continue
        acc = _int_dot(h, w)
        if skip:
            acc = acc + _shift(_int_dot(feat, w_skip[skip_i]), kp.skip_shift[skip_i])
            skip_i += 1
        pre = acc + kp.b_layers[i]
        if i == len(kp.w_layers) - 1 and kp.mode == MODE_INT8_TRUNK:
            h = torch.clamp(pre, min=0).to(torch.bfloat16).float()
        else:
            h = torch.clamp(pre >> kp.shift_layers[i], 0, 127)
    return h


@torch.no_grad()
def nerf_render_plain(
    kp: KernelParams,
    o_ph: torch.Tensor,
    d_ph: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    venc: Optional[torch.Tensor] = None,
    *,
    density_only: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the fused render kernel, all three modes. It
    evaluates every sample (no early stop), PLAIN_RAY_CHUNK rays at a time.
    Same arguments and result as `nerf_render`.

    bf16 mode: bf16 operands, fp32 sums, bf16 activations. int8 modes: the
    encoding quantized in fp32, exact integer products (`_int_dot`) and
    integer epilogues in int32 (`clip((acc + b) >> k, 0, 127)`, the skip
    product shifted before the add); int8-trunk casts the last layer's
    `max(pre, 0)` to bf16 for its bf16 heads, int8 keeps the heads integer
    until sigma and rgb."""
    n_samples, n_rays = z_vals.shape
    width, mode = kp.width, kp.mode
    int8 = mode != MODE_BF16
    w_fa, b_fa = kp.w_fa[: width + 1], kp.b_fa[: width + 1]
    if mode != MODE_INT8:
        w_fa = w_fa.float()
    out_rows = n_samples if density_only else 8
    out = torch.empty((out_rows, n_rays), dtype=torch.float32, device=z_vals.device)
    for r0 in range(0, n_rays, PLAIN_RAY_CHUNK):
        r1 = min(r0 + PLAIN_RAY_CHUNK, n_rays)
        z = z_vals[:, r0:r1].T  # [Rc, S]
        dist = dists[:, r0:r1].T
        p = o_ph[:3, r0:r1].T[:, None, :] + z[..., None] * d_ph[:3, r0:r1].T[:, None, :]
        feat = _encode_ladder(p, kp.pts_freqs)  # [Rc, S, enc] fp32
        feat = _quantize_feat(feat, kp.feat_qscale) if int8 else _bf(feat)
        h = _trunk_plain(kp, feat)
        if mode == MODE_INT8:
            fa = _int_dot(h, w_fa) + b_fa
            sigma = fa[..., width].float() * kp.s_alpha
        else:
            fa = h @ w_fa.T + b_fa
            sigma = fa[..., width]
        alpha = 1.0 - torch.exp(-torch.relu(sigma) * dist)  # [Rc, S]
        trans = exclusive_cumprod(1.0 - alpha + 1e-10)
        weights = alpha * trans
        if density_only:
            out[:, r0:r1] = weights.T
            continue
        hv_enc = venc[:, r0:r1].T.float() @ kp.w_view_enc.float().T  # [Rc, W/2]
        if mode == MODE_INT8:
            hv_q = torch.round((hv_enc + kp.b_view) * kp.inv_s_view).to(torch.int32)
            if kp.k_hv > 0:
                hv_q = hv_q + (1 << (kp.k_hv - 1))
            feature = torch.clamp(fa[..., :width] >> kp.k_feat, -127, 127)
            hv = torch.clamp((_int_dot(feature, kp.w_view_h) + hv_q[:, None, :]) >> kp.k_hv, 0, 127)
            rgb = torch.sigmoid(_int_dot(hv, kp.w_rgb[:3]).float() * kp.s_rgb + kp.b_rgb[:3])
        else:
            hv = _bf(torch.relu(
                _bf(fa[..., :width]) @ kp.w_view_h.float().T + hv_enc[:, None, :] + kp.b_view
            ))
            rgb = torch.sigmoid((hv @ kp.w_rgb[:3].float().T + kp.b_rgb[:3]))  # [Rc, S, 3]
        out[0:3, r0:r1] = (weights[..., None] * rgb).sum(1).T
        out[3, r0:r1] = (weights * z).sum(1)
        out[4, r0:r1] = weights.sum(1)
        out[5, r0:r1] = trans[:, -1] * (1.0 - alpha[:, -1] + 1e-10)
        out[6:8, r0:r1] = 0.0
    return out


# The shapes the CUDA kernel is built for, (width, point frequencies) ->
# whether the full pass is built too. Each is one library,
# csrc/fused_render.cu compiled for it (ops/_build.py).
KERNEL_SHAPES = _build.RENDER_SHAPES


def kernel_library(width: int, pts_freqs: int) -> str:
    return f"fused_render_w{width}f{pts_freqs}"


class WeightStream(NamedTuple):
    """One network's product weights as the kernel's producer streams them
    (csrc/fused_render.cu, header note): `buffer` uint8 on the weights'
    device, and per pass the table of one step's slabs as (name, offset,
    bytes, rows, k_bytes), in the order the kernel's consumers take them.
    Slab j of a matrix [rows, K] holds its bytes [128 j, 128 j + 128) of
    each row, the matrix's row bytes zero-padded to k_bytes (a multiple of
    the 32-byte k-step), in the 128-byte swizzle: byte b of row r at
    r * 128 + (((b >> 4) ^ r) & 7) * 16 + (b & 15). `n_trunk` is the count
    of the trunk's slabs, the first of either table. `c_density` and
    `c_full` hold each table as the launch entries' host arrays (slab
    offsets, slab bytes)."""

    buffer: torch.Tensor
    density: tuple
    full: tuple
    n_trunk: int
    c_density: tuple
    c_full: tuple


def _product_matrices(kp: KernelParams):
    """(trunk, density heads, full-pass heads): lists of (name, [rows, K]
    weight) in stream order."""
    w = kp.width
    skip_layer = kp.skips[0] + 1 if kp.skips else -1
    trunk = [("layer0", kp.w_layers[0])]
    for i in range(1, len(kp.w_layers)):
        if i == skip_layer:
            trunk.append(("skip", kp.w_skip_enc[0]))
        trunk.append((f"layer{i}", kp.w_layers[i]))
    density = [("alpha", kp.w_fa[w : w + 16])]
    if fa_split(w):
        heads = [("alpha", kp.w_fa[w : w + 16]), ("feature", kp.w_fa[:w])]
    else:
        heads = [("feature+alpha", kp.w_fa[: w + 16])]
    return trunk, density, heads + [("view", kp.w_view_h), ("rgb", kp.w_rgb)]


def fa_split(width: int) -> bool:
    """Whether the full pass streams and multiplies alpha and the features as
    two products (csrc/fused_render.cu `fa_split`: width + 16 columns are
    more than one wgmma takes) or as one."""
    return width + 16 > 256


def _swizzle_slabs(m: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """[rows, K] weight -> ([n_slabs, rows * 128] uint8 slabs, k_bytes)."""
    rows = m.shape[0]
    raw = m.contiguous().view(torch.uint8).reshape(rows, -1)
    k_bytes = _round_up(raw.shape[1], K_STEP_BYTES)
    n = -(-k_bytes // SLAB_ROW_BYTES)
    padded = torch.zeros(rows, n * SLAB_ROW_BYTES, dtype=torch.uint8, device=m.device)
    padded[:, : raw.shape[1]] = raw
    chunks = padded.reshape(rows, n, 8, 16).permute(1, 0, 2, 3)  # [slab, row, 16-byte chunk, byte]
    r = torch.arange(rows, device=m.device)[:, None]
    src = torch.arange(8, device=m.device)[None, :] ^ (r % 8)  # stored chunk p holds chunk p ^ (r % 8)
    slabs = torch.gather(chunks, 2, src[None, :, :, None].expand(n, rows, 8, 16))
    return slabs.reshape(n, rows * SLAB_ROW_BYTES), k_bytes


@torch.no_grad()
def pack_weight_stream(kp: KernelParams) -> WeightStream:
    """Pack one network's product weights into the stream the kernel reads
    (`WeightStream`): the trunk's slabs, then alpha's, then feature+alpha's,
    view's and rgb's, each slab 128-byte aligned. Runs once per parameter
    set (`weight_stream`)."""
    trunk, density, full = _product_matrices(kp)
    parts, tables, offset = [], {}, 0
    for key, mats in (("trunk", trunk), ("density", density), ("full", full)):
        table = []
        for name, m in mats:
            slabs, k_bytes = _swizzle_slabs(m)
            for s in slabs:
                table.append((name, offset, s.numel(), m.shape[0], k_bytes))
                parts.append(s)
                offset += s.numel()
        tables[key] = tuple(table)
    # A view at a 128-byte aligned start (the CPU allocator aligns to 64).
    raw = torch.empty(offset + SLAB_ROW_BYTES, dtype=torch.uint8, device=parts[0].device)
    start = -raw.data_ptr() % SLAB_ROW_BYTES
    buffer = raw[start : start + offset]
    torch.cat(parts, out=buffer)
    density, full = tables["trunk"] + tables["density"], tables["trunk"] + tables["full"]

    return WeightStream(buffer, density, full, len(tables["trunk"]), _build.slab_arrays(density),
                        _build.slab_arrays(full))


# Streams of recent parameter sets, by identity; each entry holds its
# KernelParams, so an id is not reused while it is cached.
_STREAMS: "Dict[int, Tuple[KernelParams, WeightStream]]" = {}
_STREAMS_KEPT = 32


def weight_stream(kp: KernelParams) -> WeightStream:
    """`pack_weight_stream(kp)`, packed at the first call for this parameter
    set and reused by every launch after it. The renderer packs its nets
    when it installs them."""
    hit = _STREAMS.pop(id(kp), None)
    if hit is None or hit[0] is not kp:
        hit = (kp, pack_weight_stream(kp))
    _STREAMS[id(kp)] = hit  # most recent last
    while len(_STREAMS) > _STREAMS_KEPT:
        del _STREAMS[next(iter(_STREAMS))]
    return hit[1]


_KP_TENSORS = ("w_layers", "w_skip_enc", "b_layers", "w_fa", "b_fa", "w_view_h", "w_view_enc", "b_view",
               "w_rgb", "b_rgb")


@torch.no_grad()
def replicate_kernel_params(kp: KernelParams, device: torch.device | str) -> KernelParams:
    """`kp` on another device: its tensors copied, and its weight stream
    (packed once, on `kp`'s device) copied into the stream cache for the
    copy, so the kernels on `device` read the same bytes without packing
    again. `kp` itself when it is on `device` already."""
    device = torch.device(device)
    if kp.w_fa.device == device:
        return kp
    moved = kp._replace(**{
        name: tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device)
        for name, v in ((n, getattr(kp, n)) for n in _KP_TENSORS)
    })
    if device.type == "cuda":
        ws = weight_stream(kp)
        raw = torch.empty(ws.buffer.numel() + SLAB_ROW_BYTES, dtype=torch.uint8, device=device)
        start = -raw.data_ptr() % SLAB_ROW_BYTES
        buffer = raw[start : start + ws.buffer.numel()]
        buffer.copy_(ws.buffer)
        _STREAMS[id(moved)] = (moved, ws._replace(buffer=buffer))
    return moved


def _launch_args(kp: KernelParams, density_only: bool) -> Tuple[tuple, tuple, int]:
    """The C arguments of `kp`'s density-only or full pass that
    `nerf_render_launch` and `nerf_ablation_launch` share
    (csrc/fused_render.cu), as (net, weights, n_trunk): net = (pointer
    array, width, point frequencies, depth, skip layer), which both take
    first; weights = (shift array, scale array, stream buffer, slab
    offsets, slab bytes, slab count), which the render entry takes after
    `mode` and the ablation entry at once, followed by n_trunk, the trunk's
    slab count. The pointers are each layer's weight and bias, the skip
    weight, alpha's weight and bias, then the full pass's feature, view and
    rgb weights and biases (nulls in the density pass)."""
    w = kp.width
    ptrs = []
    for wl, bl in zip(kp.w_layers, kp.b_layers):
        ptrs += [wl, bl]
    ptrs += [kp.w_skip_enc[0] if kp.w_skip_enc else None, kp.w_fa[w : w + 16], kp.b_fa[w : w + 16]]
    if density_only:
        ptrs += [None] * 7
    else:
        ptrs += [kp.w_fa[:w], kp.b_fa[:w], kp.w_view_h, kp.w_view_enc, kp.b_view, kp.w_rgb, kp.b_rgb]
    depth = len(kp.w_layers)
    shifts = list(kp.shift_layers) or [0] * depth
    ws = weight_stream(kp)
    table = ws.density if density_only else ws.full
    net = ((ctypes.c_void_p * len(ptrs))(*[0 if t is None else t.data_ptr() for t in ptrs]), w, kp.pts_freqs,
           depth, kp.skips[0] + 1 if kp.skips else -1)
    weights = ((ctypes.c_int * (depth + 3))(*shifts, kp.skip_shift[0] if kp.skip_shift else 0, kp.k_feat, kp.k_hv),
               (ctypes.c_float * 4)(kp.feat_qscale or 0.0, kp.s_alpha, kp.inv_s_view, kp.s_rgb),
               ws.buffer.data_ptr(), *(ws.c_density if density_only else ws.c_full), len(table))
    return net, weights, ws.n_trunk


def _check_kernel_params(kp: KernelParams, device: torch.device, density_only: bool = True) -> None:
    shape = (kp.width, kp.pts_freqs)
    if shape not in KERNEL_SHAPES or (not density_only and not KERNEL_SHAPES[shape]):
        built = ", ".join(f"{w}/F={f}" + ("" if full else " (density-only)") for (w, f), full in KERNEL_SHAPES.items())
        raise ValueError(
            f"the fused render kernel is built for width/point frequencies {built}; got width "
            f"{kp.width} with {kp.pts_freqs} point frequencies"
            + ("" if density_only else " in the full pass")
        )
    if not density_only and kp.view_freqs != VIEW_FREQS:
        raise ValueError(f"the full pass takes {VIEW_FREQS} view frequencies, got {kp.view_freqs}")
    if len(kp.skips) > 1 or len(kp.w_layers) > KERNEL_MAX_DEPTH:
        raise ValueError("the fused render kernel takes at most one skip and 16 layers")
    int8 = kp.mode != MODE_BF16
    heads8 = kp.mode == MODE_INT8
    weights = [(t, torch.int8 if int8 else torch.bfloat16) for t in (*kp.w_layers, *kp.w_skip_enc)]
    weights += [(t, torch.int8 if heads8 else torch.bfloat16) for t in (kp.w_fa, kp.w_view_h, kp.w_rgb)]
    weights += [(kp.w_view_enc, torch.bfloat16)]
    for t, dtype in weights:
        if t.dtype != dtype or t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"kernel weights must be 16-byte aligned contiguous {dtype} on {device}")
    biases = [(t, torch.int32 if int8 else torch.float32) for t in kp.b_layers]
    biases += [(kp.b_fa, torch.int32 if heads8 else torch.float32), (kp.b_view, torch.float32),
               (kp.b_rgb, torch.float32)]
    for t, dtype in biases:
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"kernel biases must be contiguous {dtype} on {device}")


def _nerf_render_cuda(kp, o_ph, d_ph, z_vals, dists, venc, density_only, early_stop_eps, importance_only,
                      live_groups):
    device = z_vals.device
    if device.type != "cuda":
        raise ValueError(f"no fused render kernel for device {device}")
    _check_kernel_params(kp, device, density_only)
    n_samples, n_rays = z_vals.shape
    for name, t in (("o_ph", o_ph), ("d_ph", d_ph), ("z_vals", z_vals), ("dists", dists)):
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {device}")
        if t.shape[-1] != n_rays:
            raise ValueError(f"{name} has {t.shape[-1]} rays, z_vals {n_rays}")
    if o_ph.shape[0] < 3 or d_ph.shape[0] < 3 or dists.shape != z_vals.shape:
        raise ValueError("o_ph/d_ph need >= 3 rows and dists z_vals' shape")
    if not density_only:
        if venc is None or venc.dtype != torch.bfloat16 or not venc.is_contiguous():
            raise ValueError("the full pass needs a contiguous bf16 venc [32, R]")
        if tuple(venc.shape) != (_enc_dim(VIEW_FREQS), n_rays) or venc.device != device:
            raise ValueError(f"venc must be [32, {n_rays}] on {device}")
    if live_groups is not None and (live_groups.dtype != torch.int32 or live_groups.device != device):
        raise ValueError("live_groups must be an int32 tensor on the kernel's device")

    net, weights, _ = _launch_args(kp, density_only)
    out_rows = n_samples if density_only else 8
    out = torch.empty((out_rows, n_rays), dtype=torch.float32, device=device)
    _build.launch(
        kernel_library(kp.width, kp.pts_freqs), "nerf_render_launch", *net, kp.mode, *weights,
        o_ph.data_ptr(), d_ph.data_ptr(), z_vals.data_ptr(), dists.data_ptr(),
        None if density_only else venc.data_ptr(), out.data_ptr(),
        n_rays, n_samples, int(density_only), float(early_stop_eps), int(importance_only),
        None if live_groups is None else live_groups.data_ptr(),
        _build.stream_handle(device),
    )
    LAUNCHES[("density_only" if density_only else "full") + _MODE_SUFFIX[kp.mode]] += 1
    return out


_MODE_SUFFIX = {MODE_BF16: "", MODE_INT8_TRUNK: "_int8_trunk", MODE_INT8: "_int8"}


def nerf_render(
    kp: KernelParams,
    o_ph: torch.Tensor,
    d_ph: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    venc: Optional[torch.Tensor] = None,
    *,
    density_only: bool = False,
    early_stop_eps: float = 1e-4,
    importance_only: bool = False,
    live_groups: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evaluate one network along a flat set of rays and composite.

    o_ph, d_ph: [enc_dim, R] fp32 (`ray_phase_vectors`); z_vals, dists:
    [S, R] fp32 sorted depths and |d|-scaled intervals (last 1e10 * |d|);
    venc: [32, R] bf16 (full pass only). Returns weights [S, R] fp32
    (density_only) or maps [8, R] fp32: rows 0-2 rgb, 3 depth, 4 acc, 5 the
    final transmittance. `kp.mode` picks bf16, int8-trunk or int8.

    On a CUDA tensor this launches the kernel on `weight_stream(kp)` (packed
    at the parameter set's first launch, if the caller did not pack it),
    which stops a block of 32 rays
    once all of them have transmittance <= early_stop_eps (exact up to eps;
    0 disables it) and, with `live_groups` (int32 [1]), adds the number of
    4-sample steps its blocks evaluated. With `importance_only` (the density
    pass of importance-only placement) the bound is min(early_stop_eps,
    1e-5 / S): the tail weights a stopped block zeroes then move no
    importance sample by more than 1/S of a bin, which the pdf's 1e-5 guard
    ensures (csrc/fused_render.cu). On a CPU tensor it runs
    `nerf_render_plain`, which evaluates every sample.
    """
    if z_vals.device.type == "cpu":
        return nerf_render_plain(kp, o_ph, d_ph, z_vals, dists, venc, density_only=density_only)
    return _nerf_render_cuda(
        kp, o_ph, d_ph, z_vals, dists, venc, density_only, early_stop_eps, importance_only, live_groups
    )


def _dists_from_z(z_vals_t: torch.Tensor, dir_norm: torch.Tensor) -> torch.Tensor:
    """[S, R] depths -> |d|-scaled interval lengths (last = 1e10)."""
    d = z_vals_t[1:] - z_vals_t[:-1]
    d = torch.cat([d, torch.full_like(d[:1], 1e10)], 0)
    return (d * dir_norm).contiguous()


class FusedRenderOutputs(NamedTuple):
    rgb: torch.Tensor  # [R, 3]
    depth: torch.Tensor  # [R]
    acc: torch.Tensor  # [R]
    disp: torch.Tensor  # [R] inverse depth (reference model_utils.py:88-97)


def _finish(maps: torch.Tensor, settings: RenderSettings, full: bool):
    rgb = maps[0:3].T
    if settings.white_background:
        rgb = rgb + (1.0 - maps[4:5].T)
    if full:
        depth, acc = maps[3], maps[4]
        disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
        return FusedRenderOutputs(rgb=rgb, depth=depth, acc=acc, disp=disp)
    return rgb


def _lattice_grid(settings: RenderSettings, grid_hw: Optional[tuple], n_rays: int) -> Optional[tuple]:
    """(rows, cols) of the flat ray axis when the placement stride applies:
    a stride > 1 and a grid whose both axes it divides; else None (exact
    per-ray placement)."""
    sub = int(settings.proposal_subsample or 1)
    if sub <= 1 or grid_hw is None:
        return None
    gh, gw = int(grid_hw[0]), int(grid_hw[1])
    if gh * gw != n_rays or gh % sub or gw % sub:
        return None
    return gh, gw


def _samples_counter(name: str, z_vals: torch.Tensor, live_groups: Optional[torch.Tensor]
                     ) -> Optional[torch.Tensor]:
    """The `live_groups` a pass over `z_vals` [S, R] launches with: the
    caller's; else, while tracing, the program counter `name` of samples
    evaluated (on the card, a device counter of 4-sample steps that the
    kernel adds to; on the CPU, whose plain pass evaluates every sample,
    R * S added here); else none."""
    if live_groups is not None or not profiler.tracing():
        return live_groups
    if z_vals.device.type == "cuda":
        return profiler.device_counter(name, z_vals.device, STEP_POINTS)
    profiler.count(name, z_vals.numel())
    return None


@torch.no_grad()
def render_rays_fused(
    kparams: Mapping[str, KernelParams],
    rays: RayBundle,
    settings: RenderSettings,
    *,
    early_stop_eps: float = 1e-4,
    full: bool = False,
    sort_rays: bool = False,
    grid_hw: Optional[tuple] = None,
    live_groups: Optional[torch.Tensor | Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Hierarchical inference of a flat bundle [R] through the fused path
    (JAX pallas_render.py:1048-1260).

    kparams: {"coarse" or "proposal": KernelParams, "fine": KernelParams},
    prepared with or without int8 quantization (each one's mode is its
    own). Semantics are the reference inference path's (deterministic
    importance samples, no sigma noise). Three launches: the density pass
    (the coarse net, or the proposal net with `settings.use_proposal`),
    placement (merged with the coarse depths, or importance-only with
    `merge_coarse=False`), the fine pass.

    grid_hw: (rows, cols) of the flat ray axis. With
    `settings.proposal_subsample` s > 1 and a grid both of whose axes s
    divides, the density pass and placement run on the lattice of every
    s-th ray per axis and each s x s block shares its corner's fine depths
    (the fine pass still evaluates every ray); otherwise placement is exact.
    sort_rays: run the fine pass in the order of the density pass's
    saturation sample, so blocks of 32 rays stop early together; exact up
    to eps (per-ray independence), outputs in the original order.
    live_groups: int32 [1] on the card; both passes add the 4-sample steps
    their blocks evaluated (`nerf_render`). A pair (density pass's, fine
    pass's) gives each pass its own. Without it, while tracing, the
    passes add the samples they evaluate to the program counters
    `render.density_samples` and `render.fine_samples`
    (`obs.profiler.read_counters`). The stages are the spans
    `fused.prepare`, `fused.density`, `fused.placement`, `fused.fine` and
    `fused.finish`.

    Returns rgb [R, 3], or FusedRenderOutputs when `full`.
    """
    s = settings.for_eval()
    kp_coarse = kparams["proposal" if s.use_proposal else "coarse"]
    kp_fine = kparams["fine"]
    density_groups, fine_groups = (live_groups, live_groups) if not isinstance(live_groups, tuple) else live_groups
    with span("fused.prepare"):
        origins, dirs = rays.origins.to(torch.float32), rays.dirs.to(torch.float32)
        near, far = rays.near.to(torch.float32), rays.far.to(torch.float32)
        n_rays = origins.shape[0]

        grid = _lattice_grid(s, grid_hw, n_rays)
        sub = int(s.proposal_subsample or 1)
        if grid is not None:
            gh, gw = grid

            def lattice(x: torch.Tensor) -> torch.Tensor:
                # [R, ...] -> [R / s^2, ...], the block-corner rays of the grid.
                return x.reshape(gh, gw, *x.shape[1:])[::sub, ::sub].reshape(-1, *x.shape[1:])

            origins_c, dirs_c, near_c, far_c = (lattice(x) for x in (origins, dirs, near, far))
        else:
            origins_c, dirs_c, near_c, far_c = origins, dirs, near, far

        o_ph_c, d_ph_c = ray_phase_vectors(origins_c, dirs_c, kp_coarse.pts_freqs)
        if kp_fine.pts_freqs == kp_coarse.pts_freqs and grid is None:
            o_ph_f, d_ph_f = o_ph_c, d_ph_c
        else:
            o_ph_f, d_ph_f = ray_phase_vectors(origins, dirs, kp_fine.pts_freqs)
        venc = encode_viewdirs_kernel_order(rays.viewdirs.to(torch.float32), num_freqs=kp_fine.view_freqs)
        dir_norm = torch.linalg.norm(dirs, dim=-1)[None, :]
        dir_norm_c = torch.linalg.norm(dirs_c, dim=-1)[None, :] if grid is not None else dir_norm

        z_coarse = coarse_z_vals(near_c, far_c, s.n_samples).T.contiguous()
        dists_coarse = _dists_from_z(z_coarse, dir_norm_c)
    with span("fused.density"):
        weights_t = nerf_render(
            kp_coarse, o_ph_c, d_ph_c, z_coarse, dists_coarse,
            density_only=True, early_stop_eps=early_stop_eps, importance_only=not s.merge_coarse,
            live_groups=_samples_counter("render.density_samples", z_coarse, density_groups),
        )
    with span("fused.placement"):
        z_fine = importance_merge(weights_t, z_coarse, s.n_importance, merge=s.merge_coarse)
        if grid is not None:
            # Every ray of an s x s block takes its corner's depths.
            gh, gw = grid
            z_fine = z_fine.reshape(-1, gh // sub, 1, gw // sub, 1).expand(-1, -1, sub, -1, sub)
            z_fine = z_fine.reshape(-1, n_rays)

        inv_perm = None
        if sort_rays and early_stop_eps > 0.0:
            # Key: the density pass's sample where cumulative opacity crosses
            # 1 - eps (S when it never does), spread from the lattice.
            csum = torch.cumsum(weights_t, 0)
            crossed = csum > 1.0 - early_stop_eps
            key = torch.where(crossed[-1], torch.argmax(crossed.to(torch.int8), 0), weights_t.shape[0])
            if grid is not None:
                gh, gw = grid
                key = key.reshape(gh // sub, 1, gw // sub, 1).expand(-1, sub, -1, sub).reshape(n_rays)
            perm = torch.sort(key, stable=True).indices
            inv_perm = torch.argsort(perm)
            z_fine, o_ph_f, d_ph_f, venc = (x[:, perm] for x in (z_fine, o_ph_f, d_ph_f, venc))
            dir_norm = dir_norm[:, perm]

    with span("fused.fine"):
        z_fine = z_fine.contiguous()
        maps = nerf_render(
            kp_fine, o_ph_f.contiguous(), d_ph_f.contiguous(), z_fine, _dists_from_z(z_fine, dir_norm),
            venc.contiguous(), early_stop_eps=early_stop_eps,
            live_groups=_samples_counter("render.fine_samples", z_fine, fine_groups),
        )
        if inv_perm is not None:
            maps = maps[:, inv_perm]
    with span("fused.finish"):
        return _finish(maps, s, full)


@torch.no_grad()
def render_rays_single_pass(
    kp: KernelParams,
    rays: RayBundle,
    settings: RenderSettings,
    *,
    n_samples: Optional[int] = None,
    early_stop_eps: float = 1e-3,
):
    """One full fused pass of one net over `n_samples` uniform depths: the
    preview of a coarse+fine checkpoint through its coarse net, no placement
    and no fine pass (JAX pallas_render.py:1263-1312). Returns rgb [R, 3]."""
    s = settings.for_eval()
    dirs = rays.dirs.to(torch.float32)
    o_ph, d_ph = ray_phase_vectors(rays.origins.to(torch.float32), dirs, kp.pts_freqs)
    venc = encode_viewdirs_kernel_order(rays.viewdirs.to(torch.float32), num_freqs=kp.view_freqs)
    z = coarse_z_vals(
        rays.near.to(torch.float32), rays.far.to(torch.float32), n_samples or s.n_samples
    ).T.contiguous()
    maps = nerf_render(
        kp, o_ph, d_ph, z, _dists_from_z(z, torch.linalg.norm(dirs, dim=-1)[None, :]), venc,
        early_stop_eps=early_stop_eps,
    )
    return _finish(maps, s, False)
