"""Fine-pass ablation: the int8 full pass with one stage changed at a time.

Counterpart of `scripts/profile_fine_ablation.py` (`_ablation_kernel`,
reached through `run_ablation`): a timing variant of the fused render
kernel's full pass with int8 trunk and heads, no early stop and no depth or
acc rows, whose `ablate` flags each change one stage. Its numbers are wrong
on purpose; what it measures is the time a stage takes, by its removal.

  (none)        the full pass
  enc           every sample of a sample group (`samples_per_step`) takes
                the features of the group's first sample
  enc-direct    sin(o_ph + z d_ph) on every live encoding row, in place of
                the polynomial and the octave ladder
  enc-nobase    the base sin/cos replaced by p * 0.11 and p * 0.12, ladder kept
  enc-noconcat  the ladder's piece-sum of coordinate 0 kept live, its int8
                level added to the group's cached features, wrapped to int8
  enc-postq, enc-stack, enc-duo
                TPU layout orderings whose numbers are the full pass's: on
                this card they are the full mode's code
  heads         sigma := h[0], rgb := h[1:4] (no feature, view, rgb layers)
  epilogue      rgb_acc += rgb + sigma (rgb the raw rgb accumulator), T kept

`run_ablation` launches the kernel (`csrc/fused_render.cu` built with
-DRENDER_ABLATE=1, its own library) for CUDA tensors and runs
`run_ablation_plain` for CPU tensors. Output [8, R] fp32: rows 0-2 the rgb
sum, row 5 the final transmittance, the other rows 0.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable

import torch

from nerf_workspaces_explorer_tpu_torch.ops import _build
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr

# Stage bits of the kernel's ablation mask (csrc/fused_render.cu A_*).
_ENC, _DIRECT, _NOBASE, _NOCONCAT, _HEADS, _EPI = 2, 4, 8, 16, 32, 64

# The encoding flags in the TPU kernel's order of precedence (its elif
# chain), then the two independent ones.
ENC_FLAGS = ("enc", "enc-direct", "enc-nobase", "enc-postq", "enc-duo", "enc-stack", "enc-noconcat")
FLAGS = ENC_FLAGS + ("heads", "epilogue")
_ENC_BITS = {"enc": _ENC, "enc-direct": _DIRECT, "enc-nobase": _NOBASE, "enc-postq": 0, "enc-duo": 0,
             "enc-stack": 0, "enc-noconcat": _NOCONCAT}

# The flag sets the kernel is built for: the ablation script's rows.
MODES = ("full", "enc", "enc-direct", "enc-nobase", "enc-noconcat", "enc-postq", "enc-stack", "enc-duo",
         "heads", "epilogue", "enc+heads+epilogue")

# Kernel launches made by `run_ablation`, by mode.
LAUNCHES = {m: 0 for m in MODES}


def mode_name(ablate: Iterable[str]) -> str:
    """Canonical name of a flag set: its flags in FLAGS order joined by '+',
    or "full"."""
    ablate = frozenset(ablate)
    unknown = ablate - set(FLAGS)
    if unknown:
        raise ValueError(f"unknown ablation flags {sorted(unknown)} (known: {', '.join(FLAGS)})")
    return "+".join(f for f in FLAGS if f in ablate) or "full"


def _mask(ablate: FrozenSet[str]) -> int:
    enc = next((f for f in ENC_FLAGS if f in ablate), None)
    return (_ENC_BITS[enc] if enc else 0) | (_HEADS if "heads" in ablate else 0) | (
        _EPI if "epilogue" in ablate else 0)


def _samples_per_step(n_samples: int, samples_per_step: int) -> int:
    while n_samples % samples_per_step:
        samples_per_step //= 2
    return samples_per_step


def _wrap_int8(x: torch.Tensor) -> torch.Tensor:
    """int32 -> the int8 value it narrows to, with wrap-around (two's complement)."""
    return ((x + 128) & 255) - 128


@torch.no_grad()
def run_ablation_plain(kp: fr.KernelParams, o_ph, d_ph, z_vals, dists, venc, ablate,
                       samples_per_step: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the ablation kernel: each flag's numbers as
    the TPU kernel's body computes them, in the kernel's arithmetic
    (`nerf_render_plain`'s int8 chain: fp32 encoding, exact integer products
    and int32 epilogues) and its sample order (one sample at a time, front
    to back), fr.PLAIN_RAY_CHUNK rays at a time. Same arguments and result
    as `run_ablation`."""
    if kp.mode != fr.MODE_INT8:
        raise ValueError("the ablation runs the int8 full pass: give it int8 kernel params (trunk and heads)")
    ablate = frozenset(ablate)
    mode_name(ablate)
    sps = _samples_per_step(z_vals.shape[0], samples_per_step)
    out = torch.zeros(8, z_vals.shape[1], device=z_vals.device)
    for r0 in range(0, z_vals.shape[1], fr.PLAIN_RAY_CHUNK):
        rays = slice(r0, r0 + fr.PLAIN_RAY_CHUNK)
        out[:, rays] = _ablation_chunk(kp, o_ph[:, rays], d_ph[:, rays], z_vals[:, rays], dists[:, rays],
                                       venc[:, rays], ablate, sps)
    return out


def _ablation_chunk(kp, o_ph, d_ph, z_vals, dists, venc, ablate, sps):
    n_samples, n_rays = z_vals.shape
    width, live = kp.width, 3 + 6 * kp.pts_freqs
    enc = next((f for f in ENC_FLAGS if f in ablate), None)
    z, dist = z_vals.T, dists.T  # [R, S]
    o3, d3 = o_ph[:3].T[:, None, :], d_ph[:3].T[:, None, :]
    p = o3 + z[..., None] * d3  # [R, S, 3]
    starts = torch.arange(n_samples, device=z.device) // sps * sps
    if enc == "enc-direct":
        enc_dim = fr._enc_dim(kp.pts_freqs)
        ph = o_ph[:enc_dim].T[:, None, :] + z[..., None] * d_ph[:enc_dim].T[:, None, :]
        row = torch.arange(enc_dim, device=z.device)
        ft = torch.where(row < 3, ph, torch.where(row < live, torch.sin(ph), 0.0))
        feat = fr._quantize_feat(ft, kp.feat_qscale)
    elif enc == "enc-nobase":
        s, c = p * 0.11, p * 0.12
        sin_rows, cos_rows = [s], [c]
        for _ in range(kp.pts_freqs - 1):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            sin_rows.append(s)
            cos_rows.append(c)
        rows = [p] + sin_rows + cos_rows
        pad = fr._enc_dim(kp.pts_freqs) - live
        if pad:
            rows.append(torch.zeros(*p.shape[:-1], pad, dtype=p.dtype, device=p.device))
        feat = fr._quantize_feat(torch.cat(rows, -1), kp.feat_qscale)
    else:
        feat = fr._quantize_feat(fr._encode_ladder(p, kp.pts_freqs), kp.feat_qscale)
        if enc in ("enc", "enc-noconcat"):
            feat = feat[:, starts]
        if enc == "enc-noconcat":
            # Coordinate 0's piece-sum, the only row of it the TPU kernel adds.
            p0 = p[..., 0]
            s, c = torch.sin(p0), torch.cos(p0)
            acc = p0 + s + c
            for _ in range(kp.pts_freqs - 1):
                s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
                acc = acc + s + c
            accq = torch.clamp(torch.round(acc * kp.feat_qscale), -127.0, 127.0).to(torch.int32)
            feat = _wrap_int8(feat + accq[..., None])
    h = fr._trunk_plain(kp, feat)  # [R, S, W] int8-valued int32
    if "heads" in ablate:
        sigma, rgb = h[..., 0].float(), h[..., 1:4].float()
    else:
        fa = fr._int_dot(h, kp.w_fa[: width + 1]) + kp.b_fa[: width + 1]
        sigma = fa[..., width].float() * kp.s_alpha
        hv_enc = venc.T.float() @ kp.w_view_enc.float().T
        hv_q = torch.round((hv_enc + kp.b_view) * kp.inv_s_view).to(torch.int32)
        if kp.k_hv > 0:
            hv_q = hv_q + (1 << (kp.k_hv - 1))
        feature = torch.clamp(fa[..., :width] >> kp.k_feat, -127, 127)
        hv = torch.clamp((fr._int_dot(feature, kp.w_view_h) + hv_q[:, None, :]) >> kp.k_hv, 0, 127)
        rgb_i = fr._int_dot(hv, kp.w_rgb[:3]).float()
        rgb = rgb_i if "epilogue" in ablate else torch.sigmoid(rgb_i * kp.s_rgb + kp.b_rgb[:3])
    rgb_acc = torch.zeros(n_rays, 3, device=z.device)
    trans = torch.ones(n_rays, device=z.device)
    for k in range(n_samples):
        if "epilogue" in ablate:
            rgb_acc = rgb_acc + rgb[:, k] + sigma[:, k, None]
            continue
        alpha = 1.0 - torch.exp(-torch.relu(sigma[:, k]) * dist[:, k])
        weight = alpha * trans
        rgb_acc = rgb_acc + weight[:, None] * rgb[:, k]
        trans = trans * (1.0 - alpha + 1e-10)
    out = torch.zeros(8, n_rays, device=z.device)
    out[0:3] = rgb_acc.T
    out[5] = trans
    return out


def _run_ablation_cuda(kp, o_ph, d_ph, z_vals, dists, venc, ablate, samples_per_step):
    device = z_vals.device
    if device.type != "cuda":
        raise ValueError(f"no ablation kernel for device {device}")
    if (kp.width, kp.pts_freqs) not in _build.ABLATION_SHAPES:
        built = ", ".join(f"{w}/F={f}" for w, f in _build.ABLATION_SHAPES)
        raise ValueError(f"the ablation kernel is built for width/point frequencies {built}; got "
                         f"{kp.width}/F={kp.pts_freqs}")
    if kp.mode != fr.MODE_INT8:
        raise ValueError("the ablation runs the int8 full pass: give it int8 kernel params (trunk and heads)")
    fr._check_kernel_params(kp, device, density_only=False)
    n_samples, n_rays = z_vals.shape
    enc_dim = fr._enc_dim(kp.pts_freqs)
    for name, t, rows in (("o_ph", o_ph, enc_dim), ("d_ph", d_ph, enc_dim), ("z_vals", z_vals, n_samples),
                          ("dists", dists, n_samples)):
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() or t.shape != (rows, n_rays):
            raise ValueError(f"{name} must be contiguous float32 [{rows}, {n_rays}] on {device}")
    if venc is None or venc.dtype != torch.bfloat16 or not venc.is_contiguous() or venc.device != device or \
            tuple(venc.shape) != (fr._enc_dim(fr.VIEW_FREQS), n_rays):
        raise ValueError(f"venc must be contiguous bf16 [32, {n_rays}] on {device}")
    net, weights, n_trunk = fr._launch_args(kp, density_only=False)
    out = torch.empty((8, n_rays), dtype=torch.float32, device=device)
    _build.launch(
        f"fused_render_ablate_w{kp.width}f{kp.pts_freqs}", "nerf_ablation_launch", *net, *weights, n_trunk,
        o_ph.data_ptr(), d_ph.data_ptr(), z_vals.data_ptr(), dists.data_ptr(), venc.data_ptr(), out.data_ptr(),
        n_rays, n_samples, samples_per_step, _mask(ablate), _build.stream_handle(device),
    )
    LAUNCHES[mode_name(ablate)] += 1
    return out


def run_ablation(kp: fr.KernelParams, o_ph, d_ph, z_vals, dists, venc, ablate,
                 samples_per_step: int = 32) -> torch.Tensor:
    """The TPU script's `run_ablation` with tensors: kp int8 kernel params
    (trunk and heads, `prepare_kernel_params` with an int8 calibration);
    o_ph, d_ph [enc_dim, R] fp32 (`ray_phase_vectors`, every row); z_vals,
    dists [S, R] fp32; venc [32, R] bf16; ablate a set of flags (module
    note) that MODES lists. samples_per_step halves until it divides S.
    Returns [8, R] fp32: rows 0-2 the rgb sum, row 5 the final T.

    On a CUDA tensor this launches the ablation kernel (every sample, no
    early stop); on a CPU tensor it runs `run_ablation_plain`."""
    ablate = frozenset(ablate)
    name = mode_name(ablate)
    if name not in MODES:
        raise ValueError(f"the ablation kernel is built for the modes {', '.join(MODES)}; got {name}")
    sps = _samples_per_step(z_vals.shape[0], samples_per_step)
    if z_vals.device.type == "cpu":
        return run_ablation_plain(kp, o_ph, d_ph, z_vals, dists, venc, ablate, sps)
    return _run_ablation_cuda(kp, o_ph, d_ph, z_vals, dists, venc, ablate, sps)
