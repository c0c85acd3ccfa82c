#!/usr/bin/env python3
"""Probe: do int4 operands reach the tensor cores through the port's kernel?

The PyTorch/CUDA counterpart of `scripts/probe_int4_tpu.py`, with its two
legs, each `int4 [128, 128] widened to bf16 @ bf16 [128, 128] -> fp32`
through `ops/int4_probe.py::int4_matmul` (`csrc/int4_probe.cu`):

  1. int4-operand: the int4 matrix one value per byte, and
  2. int4x2-packed-bytes: two values per byte, unpacked in the kernel by
     shifts (the packing a render kernel would use for its weights).

Each leg is checked against numpy by its relative error (< 2e-2, as the TPU
probe checks it). Prints one verdict line per leg and INT4 VIABLE or INT4
BLOCKED; exits 0 if a leg works, 1 otherwise. Runs on the CUDA card unless
given `--device cpu` (then the legs are the kernels' plain versions). From
the repository root:

    python3 scripts/probe_int4_torch.py [--device cuda|cpu] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from nerf_workspaces_explorer_tpu_torch.ops.int4_probe import int4_matmul, pack_int4_rows  # noqa: E402

N = 128
TOL = 2e-2  # probe_int4_tpu.py's verdict bound


def leg_inputs(packed: bool, device: torch.device):
    """One leg's operands from numpy's global generator, drawn in the TPU
    probe's order (the int4 matrix, then b): (a, b, reference [N, N])."""
    w4 = np.random.randint(-8, 8, size=(N, N)).astype(np.int8)
    b = torch.from_numpy(np.random.randn(N, N).astype(np.float32)).to(torch.bfloat16)
    ref = w4.astype(np.float32) @ b.float().numpy()
    a = torch.from_numpy(w4)
    if packed:
        a = pack_int4_rows(a)
    return a.to(device), b.to(device), ref


def rel_err(out: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.max(np.abs(out.cpu().numpy() - ref))) / (float(np.max(np.abs(ref))) + 1e-9)


def run_legs(device: torch.device):
    """[(leg name, rel err against numpy)] for both legs."""
    legs = []
    for name, packed in (("int4-operand", False), ("int4x2-packed-bytes", True)):
        a, b, ref = leg_inputs(packed, device)
        legs.append((name, rel_err(int4_matmul(a, b, packed=packed), ref)))
    return legs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain versions)"
    print(f"torch {torch.__version__}, device: {kind}")
    np.random.seed(args.seed)
    ok = False
    for name, err in run_legs(device):
        good = err < TOL
        ok = ok or good
        print(f"[{name}] {'OK' if good else 'WRONG RESULT'} (rel err {err:.3g})")
    print("INT4 VIABLE" if ok else "INT4 BLOCKED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
