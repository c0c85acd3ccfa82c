#!/usr/bin/env python3
"""Where a frame of the PyTorch port's main path spends its time, on a CUDA card.

Serves warm 320x240 frames through `Workspace.render_image` at
precision="fast" under `torch.profiler` and prints, per frame, the wall
time, the device time summed over kernels, the device idle share
(1 - device time / wall time) and the device time by kernel name. Run from
the repository root:

    python3 scripts/profile_torch_frame.py
"""

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 3  # profiled warm frames, averaged


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nerf_workspaces_explorer_tpu_torch.app.workspace import OfficeTokyoWorkspace

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    office = OfficeTokyoWorkspace(
        ckpt_path=os.path.join(ROOT, "assets", "bench", "synth_hier.npz"), precision="fast"
    )
    office.initialize_models()
    click = (0.5, 0.5, 0, 0)
    office.render_image(*click)  # warm-up: kernel build and first launches
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            office.render_image(*click)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    kernels = [
        e for e in prof.key_averages()
        if _device_us(e) > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / FRAMES
    print(f"card: {card}")
    print(f"frame: wall {wall_ms:.2f} ms, device {device_ms:.2f} ms, "
          f"device idle share {1.0 - device_ms / wall_ms:.3f} (over {FRAMES} frames)")
    if not kernels:
        print("no device time captured by the profiler")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) / 1e3 / FRAMES:9.3f} ms/frame  x{e.count // FRAMES:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
