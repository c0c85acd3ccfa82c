#!/usr/bin/env python3
"""Attribute the fine pass's per-sample time by ablation, on a CUDA card.

The PyTorch/CUDA counterpart of `scripts/profile_fine_ablation.py`: it times
the int8 full pass of a turbo student (default the 4x128@8f student of
`assets/bench/synth_proposal.turbo.npz`, calibrated int8 trunk and heads) on
an identity-pose frame of `--width` x `--height` rays x `--samples` uniform
depths in [0.1, 6], then the ablation kernel (`ops/fine_ablation.py`, K8:
the same kernel with one stage changed, on the same 32-ray blocks and
4-sample steps) in each of the TPU script's rows:

  full          the served int8 full pass (`nerf_render`, eps 0)
  enc ...       the encoding flags: enc, enc-direct, enc-nobase,
                enc-noconcat, and enc-postq, enc-stack, enc-duo (TPU layout
                orderings: on this card the full mode's code)
  no-heads      trunk only; sigma := h[0], rgb := h[1:4]
  no-epilogue   rgb and sigma folded with plain adds
  trunk-only    enc + no-heads + no-epilogue

Each row prints its ms (CUDA events, mean of --reps launches after one
warm-up), the ms it removes from the full pass, and its bound (the tensor
core operations of the samples over the int8 peak, or the bytes over the
memory rate, whichever is larger); the last line is the card's name and
power limit. From the repository root:

    python3 scripts/profile_torch_fine_ablation.py [--sidecar PATH] [--samples 48]
        [--width 640] [--height 480] [--sps 32] [--reps 5]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.ops import fine_ablation as fa  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_model_quant  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.train.distill import (  # noqa: E402
    load_turbo_checkpoint,
    read_turbo_metadata,
    student_spec_from_meta,
)

SIDECAR = os.path.join(ROOT, "assets", "bench", "synth_proposal.turbo.npz")
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# (row label, ablation flags; None = the served full pass)
ROWS = (
    ("full", None),
    ("enc", ("enc",)),
    ("enc-direct", ("enc-direct",)),
    ("enc-nobase", ("enc-nobase",)),
    ("enc-noconcat", ("enc-noconcat",)),
    ("enc-postq", ("enc-postq",)),
    ("enc-stack", ("enc-stack",)),
    ("enc-duo", ("enc-duo",)),
    ("no-heads", ("heads",)),
    ("no-epilogue", ("epilogue",)),
    ("trunk-only", ("enc", "heads", "epilogue")),
)


def student_inputs(sidecar: str, n_samples: int, width: int, height: int, device: torch.device):
    """The student's int8 fine-net kernel params and one frame's kernel
    inputs: (kp, (o_ph, d_ph, z [S, R], dists, venc))."""
    params, _ = load_turbo_checkpoint(sidecar)
    spec, _ = student_spec_from_meta(read_turbo_metadata(sidecar))
    quant = calibrate_model_quant(params, spec)
    kp = fr.prepare_kernel_params(params_from_numpy(params["fine"], device), spec, quant=quant["fine"])
    eye = torch.eye(4, device=device)[None]
    rays = create_rays(eye, height, width, 320.0, 320.0, width / 2 - 0.5, height / 2 - 0.5, 0.1, 6.0)
    rays = rays.reshape(height * width)
    o_ph, d_ph = fr.ray_phase_vectors(rays.origins, rays.dirs, kp.pts_freqs)
    venc = fr.encode_viewdirs_kernel_order(rays.viewdirs, num_freqs=kp.view_freqs)
    z = coarse_z_vals(rays.near, rays.far, n_samples).T.contiguous()
    dists = fr._dists_from_z(z, torch.linalg.norm(rays.dirs, dim=-1)[None])
    return kp, (o_ph, d_ph, z, dists, venc)


def bound_ms(kp, ablate, n_rays: int, n_samples: int):
    """(least ms, "operations" or "bytes") of one row: every sample's tensor
    core multiply-adds (the trunk; the alpha, feature, view and rgb heads
    unless "heads"; the per-ray view term) at the int8 peak, against its
    bytes (the phase rows it reads, depths and intervals, view encoding,
    output, weights) at the memory rate."""
    ablate = ablate or ()
    half = kp.width // 2
    macs = sum(w.shape[0] * w.shape[1] for w in (*kp.w_layers, *kp.w_skip_enc))
    if "heads" not in ablate:
        macs += kp.width + kp.width * kp.width + half * kp.width + 3 * half
    ops = 2 * (macs * n_samples + half * kp.w_view_enc.shape[1]) * n_rays
    phase_rows = 3 + 6 * kp.pts_freqs if "enc-direct" in ablate else 3
    weights = (*kp.w_layers, *kp.w_skip_enc, *kp.b_layers, kp.w_fa, kp.b_fa, kp.w_view_h, kp.w_view_enc,
               kp.b_view, kp.w_rgb, kp.b_rgb)
    nbytes = (2 * phase_rows * 4 + 2 * n_samples * 4 + 32 * 2 + 8 * 4) * n_rays
    nbytes += sum(t.numel() * t.element_size() for t in weights)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attribution(kp, inputs, sps: int, reps: int):
    """Time every row on the card: [{label, ablate, ms, removed_ms, bound_ms,
    bound_by}], "full" first."""
    n_samples, n_rays = inputs[2].shape
    rows = []
    for label, ablate in ROWS:
        if ablate is None:
            fn = lambda: fr.nerf_render(kp, *inputs, early_stop_eps=0.0)  # noqa: E731
        else:
            fn = lambda ablate=ablate: fa.run_ablation(kp, *inputs, frozenset(ablate),  # noqa: E731
                                                        samples_per_step=sps)
        ms = time_ms(fn, reps)
        b, by = bound_ms(kp, ablate, n_rays, n_samples)
        rows.append(dict(label=label, ablate=ablate, ms=ms, removed_ms=rows[0]["ms"] - ms if rows else 0.0,
                         bound_ms=b, bound_by=by))
    return rows


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def print_rows(rows, n_samples: int, sps: int) -> None:
    full = rows[0]["ms"]
    print(f"{'row':14s} {'ms':>9s} {'removed':>9s} {'share':>7s} {'bound ms':>9s}")
    for r in rows:
        label = f"{r['label']} {n_samples}s sps={sps}" if r["ablate"] is None else r["label"]
        print(f"{label:14s} {r['ms']:9.3f} {r['removed_ms']:9.3f} {r['removed_ms'] / full:7.1%} "
              f"{r['bound_ms']:9.4f} ({r['bound_by']})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sidecar", type=str, default=SIDECAR)
    ap.add_argument("--samples", type=int, default=48)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--sps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    while args.samples % args.sps:
        args.sps //= 2
    device = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}; {os.path.relpath(args.sidecar, ROOT)}, "
          f"{args.width}x{args.height} rays x {args.samples} samples", flush=True)
    kp, inputs = student_inputs(args.sidecar, args.samples, args.width, args.height, device)
    print_rows(attribution(kp, inputs, args.sps, args.reps), args.samples, args.sps)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
