#!/usr/bin/env python3
"""Record the training field backward's outputs for `tests/test_torch_gpu.py::
test_field_backward_bit_equal_to_recorded`, on a CUDA card.

Launches K5 once for every (shape, points) of that test's grid
(`FIELD_BIT_CASES`: the stock 8x256 net with its skip, the 6x192@10f and
4x128@8f students, the 2x64@6f/2f proposal net; 1,000 and 65,573 points) on
its fixed seeded inputs, and writes each dW and db buffer's size, SHA-256
digest and sampled values to one `.npz`, keyed as the test reads them.
Record from the commit whose outputs the kernels must keep; run from the
repository root:

    python3 scripts/record_field_bits.py --out tests/field_backward_bits.npz
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "field_backward_bits.npz"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("record_field_bits: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_gpu as t

    device = torch.device("cuda")
    arrays = {}
    for case in t.FIELD_BIT_CASES:
        key = t.field_bits_key(*case)
        dw, db = t.field_bits_case(device, *case)
        arrays.update(t.field_bits_record(key, dw, db))
        print(f"{key}: dw {dw.size} finite {bool(np.isfinite(dw).all())} {arrays[key + '__dw_sha256']}; "
              f"db {db.size} finite {bool(np.isfinite(db).all())} {arrays[key + '__db_sha256']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {len(arrays)} arrays to {args.out} ({os.path.getsize(args.out)} bytes) on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
