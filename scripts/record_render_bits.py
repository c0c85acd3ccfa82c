#!/usr/bin/env python3
"""Record the render kernel's outputs for `tests/test_torch_gpu.py::
test_render_kernel_bit_equal_to_recorded`, on a CUDA card.

Launches K1/K3/K7 once for every (net, mode, pass) of that test's grid
(`BIT_CASES`: the proposal, student and 8x256 shapes; bf16, int8-trunk and
int8; density and full passes) on its fixed seeded inputs, and writes the
float32 outputs to one compressed `.npz`, keyed as the test reads them.
Record from the commit whose outputs the kernel must keep; run from the
repository root:

    python3 scripts/record_render_bits.py --out tests/render_kernel_bits.npz
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "render_kernel_bits.npz"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("record_render_bits: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_gpu as t

    device = torch.device("cuda")
    arrays = {}
    for case in t.BIT_CASES:
        out = t.render_bits_case(device, *case).cpu().numpy()
        arrays[t.render_bits_key(*case)] = out
        print(f"{t.render_bits_key(*case)}: {out.shape}, finite {bool(np.isfinite(out).all())}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {len(arrays)} arrays to {args.out} ({os.path.getsize(args.out)} bytes) on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
