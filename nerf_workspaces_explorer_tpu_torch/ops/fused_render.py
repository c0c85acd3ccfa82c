"""The fused inference path: encoding + MLP + volume compositing per pass.

Counterpart of `nerf_workspaces_explorer_tpu/ops/pallas_render.py` (bf16
modes): `render_rays_fused` runs the coarse pass density-only, places the
fine samples (`ops/importance_merge.py`), then runs the fine pass with all
heads, compositing on the fly so that raw rgba never reaches device memory.

`nerf_render` launches the CUDA kernel `csrc/fused_render.cu` for CUDA
tensors and runs `nerf_render_plain` for CPU tensors. Both compute what the
TPU kernel computes: the point encoding from per-ray phase vectors (one
polynomial sin/cos per coordinate and octave doubling for the higher
frequencies, rows in kernel order [identity | sin | cos | pad]), bf16
operands with fp32 accumulation and bf16 activations between layers, the
skip concat and the view concat folded into sums of two products, the view
encoding's product once per ray, and front-to-back compositing with running
transmittance. Arrays at this module's functions keep the JAX package's
ray-minor layout ([features, rays]), so the two compare like with like.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops import _build
from nerf_workspaces_explorer_tpu_torch.ops.importance_merge import importance_merge
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings
from nerf_workspaces_explorer_tpu_torch.render.volume import exclusive_cumprod

PTS_FREQS = 10
VIEW_FREQS = 4

# Kernel launches made by `nerf_render`, by mode: the coarse pass is
# density-only, the fine pass full.
LAUNCHES = {"density_only": 0, "full": 0}

# Rays per step of the plain version (bounds its activations to ~1 GB at
# 192 samples per ray).
PLAIN_RAY_CHUNK = 4096

# The CUDA kernel is built for the flagship network: width 256, point
# encoding F=10 (64 rows), view encoding F=4 (32 rows), at most one skip.
KERNEL_WIDTH = 256
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


class KernelParams(NamedTuple):
    """One network's weights in kernel layout: weights [out, in] bf16,
    biases [out] fp32 (bf16 mode of the JAX package's KernelParams)."""

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


def prepare_kernel_params(
    params: Dict[str, Any], spec: Optional[NerfMLPSpec] = None
) -> KernelParams:
    """One network's [in, out] parameter tree -> kernel layout, on the tree's
    device (`prepare_kernel_params` of the JAX package, bf16 mode)."""
    spec = spec or NerfMLPSpec()
    if not spec.use_view_dirs or spec.width % 16:
        raise ValueError("the fused path takes view-dirs models of width divisible by 16")
    pts_freqs = _freqs_from_input_ch(spec.input_ch)
    view_freqs = _freqs_from_input_ch(spec.input_ch_views)
    pts_perm = _encoding_permutation(pts_freqs, _enc_dim(pts_freqs))
    view_perm = _encoding_permutation(view_freqs, _enc_dim(view_freqs))
    width = spec.width
    fa_rows = _round_up(width + 8, 128)
    f32 = lambda x: x.to(torch.float32)  # noqa: E731

    w_layers, w_skip_enc, b_layers = [], [], []
    for i, layer in enumerate(params["pts"]):
        w = f32(layer["w"])  # [in, out]
        if i == 0:
            w_t = _permute_pad_in_rows(w, pts_perm).T
        elif (i - 1) in spec.skips:
            # Concat order [input_pts, h] (reference nerf_model.py:59).
            w_skip_enc.append(_permute_pad_in_rows(w[: spec.input_ch], pts_perm).T)
            w_t = w[spec.input_ch :].T
        else:
            w_t = w.T
        w_layers.append(w_t)
        b_layers.append(f32(layer["b"]))

    device = w_layers[0].device
    w_fa = torch.zeros((fa_rows, width), dtype=torch.float32, device=device)
    w_fa[:width] = f32(params["feature"]["w"]).T
    w_fa[width] = f32(params["alpha"]["w"])[:, 0]
    b_fa = torch.zeros((fa_rows,), dtype=torch.float32, device=device)
    b_fa[:width] = f32(params["feature"]["b"])
    b_fa[width] = f32(params["alpha"]["b"])[0]

    w_view = f32(params["views"][0]["w"])  # [width + view_in, width // 2]
    w_rgb = torch.zeros((16, width // 2), dtype=torch.float32, device=device)
    w_rgb[:3] = f32(params["rgb"]["w"]).T
    b_rgb = torch.zeros((16,), dtype=torch.float32, device=device)
    b_rgb[:3] = f32(params["rgb"]["b"])

    cast = lambda x: x.to(torch.bfloat16).contiguous()  # noqa: E731
    return KernelParams(
        w_layers=tuple(cast(w) for w in w_layers),
        w_skip_enc=tuple(cast(w) for w in w_skip_enc),
        b_layers=tuple(b.contiguous() for b in b_layers),
        w_fa=cast(w_fa),
        b_fa=b_fa,
        w_view_h=cast(w_view[:width].T),
        w_view_enc=cast(_permute_pad_in_rows(w_view[width:], view_perm).T),
        b_view=f32(params["views"][0]["b"]).contiguous(),
        w_rgb=cast(w_rgb),
        b_rgb=b_rgb,
        skips=tuple(spec.skips),
        width=width,
        pts_freqs=pts_freqs,
        view_freqs=view_freqs,
    )


def ray_phase_vectors(
    origins: torch.Tensor, dirs: torch.Tensor, num_freqs: int = PTS_FREQS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray phase offset/slope [enc_dim, R] each, so that sample z's
    encoding phases are `o_ph + z * d_ph` (cos pi/2 bias folded into o_ph).
    The kernels read rows 0-2, the base phases coord / 10."""
    enc_dim = _enc_dim(num_freqs)
    scales = torch.as_tensor(_phase_scales(num_freqs, enc_dim, 10.0), device=origins.device)
    bias = torch.as_tensor(_cos_bias(num_freqs, enc_dim), device=origins.device)
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
    scales = torch.as_tensor(_phase_scales(num_freqs, enc_dim, 1.0), device=viewdirs.device)
    bias = torch.as_tensor(_cos_bias(num_freqs, enc_dim), device=viewdirs.device)
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
    """Plain PyTorch version of the fused render kernel. It evaluates every
    sample (no early stop), PLAIN_RAY_CHUNK rays at a time. Same arguments
    and result as `nerf_render`."""
    n_samples, n_rays = z_vals.shape
    width = kp.width
    w_layers = [w.float() for w in kp.w_layers]
    w_skip = [w.float() for w in kp.w_skip_enc]
    w_fa, b_fa = kp.w_fa[: width + 1].float(), kp.b_fa[: width + 1]
    out_rows = n_samples if density_only else 8
    out = torch.empty((out_rows, n_rays), dtype=torch.float32, device=z_vals.device)
    for r0 in range(0, n_rays, PLAIN_RAY_CHUNK):
        r1 = min(r0 + PLAIN_RAY_CHUNK, n_rays)
        z = z_vals[:, r0:r1].T  # [Rc, S]
        dist = dists[:, r0:r1].T
        p = o_ph[:3, r0:r1].T[:, None, :] + z[..., None] * d_ph[:3, r0:r1].T[:, None, :]
        feat = _bf(_encode_ladder(p, kp.pts_freqs))  # [Rc, S, enc]
        h, skip_i = feat, 0
        for i, w in enumerate(w_layers):
            acc = h @ w.T
            if i > 0 and (i - 1) in kp.skips:
                acc = acc + feat @ w_skip[skip_i].T
                skip_i += 1
            h = _bf(torch.relu(acc + kp.b_layers[i]))
        fa = h @ w_fa.T + b_fa
        alpha = 1.0 - torch.exp(-torch.relu(fa[..., width]) * dist)  # [Rc, S]
        trans = exclusive_cumprod(1.0 - alpha + 1e-10)
        weights = alpha * trans
        if density_only:
            out[:, r0:r1] = weights.T
            continue
        hv_enc = venc[:, r0:r1].T.float() @ kp.w_view_enc.float().T  # [Rc, W/2]
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


def _kernel_pointers(kp: KernelParams, density_only: bool) -> list:
    """Device pointers in `nerf_render_launch`'s order (csrc/fused_render.cu)."""
    w = kp.width
    ptrs = []
    for wl, bl in zip(kp.w_layers, kp.b_layers):
        ptrs += [wl, bl]
    ptrs += [kp.w_skip_enc[0] if kp.w_skip_enc else None, kp.w_fa[w : w + 16], kp.b_fa[w : w + 16]]
    if density_only:
        ptrs += [None] * 7
    else:
        ptrs += [kp.w_fa[:w], kp.b_fa[:w], kp.w_view_h, kp.w_view_enc, kp.b_view, kp.w_rgb, kp.b_rgb]
    return ptrs


def _check_kernel_params(kp: KernelParams, device: torch.device) -> None:
    if (kp.width, kp.pts_freqs, kp.view_freqs) != (KERNEL_WIDTH, PTS_FREQS, VIEW_FREQS):
        raise ValueError(
            "the fused render kernel is built for width 256 with 10 point and 4 view "
            f"frequencies, got width {kp.width}, {kp.pts_freqs}/{kp.view_freqs}"
        )
    if len(kp.skips) > 1 or len(kp.w_layers) > KERNEL_MAX_DEPTH:
        raise ValueError("the fused render kernel takes at most one skip and 16 layers")
    for t in (*kp.w_layers, *kp.w_skip_enc, kp.w_fa, kp.w_view_h, kp.w_view_enc, kp.w_rgb):
        if t.dtype != torch.bfloat16 or t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"kernel weights must be 16-byte aligned contiguous bf16 on {device}")
    for t in (*kp.b_layers, kp.b_fa, kp.b_view, kp.b_rgb):
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"kernel biases must be contiguous float32 on {device}")


def _nerf_render_cuda(kp, o_ph, d_ph, z_vals, dists, venc, density_only, early_stop_eps, live_groups):
    device = z_vals.device
    if device.type != "cuda":
        raise ValueError(f"no fused render kernel for device {device}")
    _check_kernel_params(kp, device)
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

    ptrs = _kernel_pointers(kp, density_only)
    ptr_array = (ctypes.c_void_p * len(ptrs))(*[0 if t is None else t.data_ptr() for t in ptrs])
    skip_layer = kp.skips[0] + 1 if kp.skips else -1
    lib = _build.load("fused_render")
    fn = lib.nerf_render_launch
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    out_rows = n_samples if density_only else 8
    out = torch.empty((out_rows, n_rays), dtype=torch.float32, device=device)
    code = fn(
        ctypes.cast(ptr_array, ctypes.c_void_p), len(kp.w_layers), skip_layer,
        o_ph.data_ptr(), d_ph.data_ptr(), z_vals.data_ptr(), dists.data_ptr(),
        None if density_only else venc.data_ptr(), out.data_ptr(),
        n_rays, n_samples, int(density_only), float(early_stop_eps),
        None if live_groups is None else live_groups.data_ptr(),
        _build.stream_handle(device),
    )
    _build.check(code, "nerf_render_launch")
    LAUNCHES["density_only" if density_only else "full"] += 1
    return out


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
    live_groups: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evaluate one network along a flat set of rays and composite.

    o_ph, d_ph: [enc_dim, R] fp32 (`ray_phase_vectors`); z_vals, dists:
    [S, R] fp32 sorted depths and |d|-scaled intervals (last 1e10 * |d|);
    venc: [32, R] bf16 (full pass only). Returns weights [S, R] fp32
    (density_only) or maps [8, R] fp32: rows 0-2 rgb, 3 depth, 4 acc, 5 the
    final transmittance.

    On a CUDA tensor this launches the kernel, which stops a block of 32 rays
    once all of them have transmittance <= early_stop_eps (exact up to eps;
    0 disables it) and, with `live_groups` (int32 [1]), adds the number of
    4-sample steps its blocks evaluated. On a CPU tensor it runs
    `nerf_render_plain`, which evaluates every sample.
    """
    if z_vals.device.type == "cpu":
        return nerf_render_plain(kp, o_ph, d_ph, z_vals, dists, venc, density_only=density_only)
    return _nerf_render_cuda(
        kp, o_ph, d_ph, z_vals, dists, venc, density_only, early_stop_eps, live_groups
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


@torch.no_grad()
def render_rays_fused(
    kparams: Mapping[str, KernelParams],
    rays: RayBundle,
    settings: RenderSettings,
    *,
    early_stop_eps: float = 1e-4,
    full: bool = False,
):
    """Coarse+fine inference of a flat bundle [R] through the fused path.

    kparams: {"coarse": KernelParams, "fine": KernelParams}. Semantics are
    the reference inference path's (deterministic importance samples, no
    sigma noise); the coarse pass is density-only because at inference its
    only consumer is the importance sampler. Three launches: coarse
    (density-only), importance merge, fine (full).

    Returns rgb [R, 3], or FusedRenderOutputs when `full`.
    """
    eval_settings = settings.for_eval()
    kp_coarse, kp_fine = kparams["coarse"], kparams["fine"]
    if kp_fine.pts_freqs != kp_coarse.pts_freqs:
        raise ValueError("the coarse and fine nets must share their point encoding")
    dirs = rays.dirs.to(torch.float32)
    o_ph, d_ph = ray_phase_vectors(rays.origins.to(torch.float32), dirs, kp_coarse.pts_freqs)
    venc = encode_viewdirs_kernel_order(rays.viewdirs.to(torch.float32), num_freqs=kp_fine.view_freqs)
    dir_norm = torch.linalg.norm(dirs, dim=-1)[None, :]

    z_coarse = coarse_z_vals(
        rays.near.to(torch.float32), rays.far.to(torch.float32), eval_settings.n_samples
    ).T.contiguous()
    weights_t = nerf_render(
        kp_coarse, o_ph, d_ph, z_coarse, _dists_from_z(z_coarse, dir_norm),
        density_only=True, early_stop_eps=early_stop_eps,
    )
    z_fine = importance_merge(weights_t, z_coarse, eval_settings.n_importance)
    maps = nerf_render(
        kp_fine, o_ph, d_ph, z_fine, _dists_from_z(z_fine, dir_norm), venc,
        early_stop_eps=early_stop_eps,
    )
    rgb = maps[0:3].T
    if eval_settings.white_background:
        rgb = rgb + (1.0 - maps[4:5].T)
    if full:
        depth, acc = maps[3], maps[4]
        disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10)
        return FusedRenderOutputs(rgb=rgb, depth=depth, acc=acc, disp=disp)
    return rgb
