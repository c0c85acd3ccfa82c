#!/usr/bin/env python3
"""Times K11 (`csrc/mipnerf360.cu`'s dense layer) at mip-NeRF 360's layer
shapes: CUDA events over 20 launches a reading, the least of two readings,
the rate against the bf16 peak.

    python3 scripts/time_torch_m360_linear.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nerf_workspaces_explorer_tpu_torch.ops import _build  # noqa: E402
from nerf_workspaces_explorer_tpu_torch.ops import mipnerf360 as m3  # noqa: E402

PEAK = 989.4e12
# (name, epilogue, rows, k-tiles of the first and second source, columns,
# layers: the proposal MLP is one launch of four)
SHAPES = (("nerf hidden", "hidden", 65536, 16, 0, 1024, 1), ("nerf skip", "hidden", 65536, 16, 8, 1024, 1),
          ("nerf first", "hidden", 65536, 8, 0, 1024, 1), ("prop", "prop", 131072, 8, 0, 256, 4))


def reading(lib: str, args: tuple, n: int = 20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        _build.launch(lib, "m360_linear_launch", *args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    _build.build([m3.LIBRARY])
    dev = torch.device("cuda")
    stream = _build.stream_handle(dev)
    out = {"device": torch.cuda.get_device_name(0)}
    for name, epi, rows, kt0, kt1, n, layers in SHAPES:
        kts = kt0 + kt1 + (layers - 1) * n // 64
        a0 = (torch.randn(rows // 64, kt0, 64, 64, device=dev) * 0.5).to(torch.bfloat16)
        a1 = (torch.randn(rows // 64, max(kt1, 1), 64, 64, device=dev) * 0.5).to(torch.bfloat16)
        w = (torch.randn(n // 256, kts, 256, 64, device=dev) * 0.05).to(torch.bfloat16)
        bias = torch.zeros(n * layers, device=dev)
        dst = torch.empty(rows // 64, n // 64, 64, 64, dtype=torch.bfloat16, device=dev)
        dens = torch.empty(rows, n // 256, device=dev)
        wd = torch.zeros(n, device=dev)
        call = (m3.EPI[epi], a0.data_ptr(), kt0, a1.data_ptr(), kt1, w.data_ptr(), bias.data_ptr(), 0,
                dst.data_ptr(), n // 64, dens.data_ptr(), wd.data_ptr(), 0, 0, 0, rows, n, stream)
        flops = 2.0 * rows * 64 * kts * n
        reading(m3.LIBRARY, call, 3)
        ms = min(reading(m3.LIBRARY, call) for _ in range(2))
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9, "peak_share": flops / ms / 1e9 / (PEAK / 1e12)}
        print(name, json.dumps(out[name]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
