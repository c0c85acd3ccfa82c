#!/usr/bin/env python3
"""Where a frame of the PyTorch port's serving path spends its time, on a CUDA card.

Serves warm 320x240 frames under `torch.profiler` and prints, per frame, the
wall time, the device time summed over kernels, the device idle share
(1 - device time / wall time) and the device time by kernel name: the 15
longest kernels, and the placement kernel wherever it ranks. Run from
the repository root:

    python3 scripts/profile_torch_frame.py                       # reference preset, fast (bf16)
    python3 scripts/profile_torch_frame.py --preset turbo --precision int8

The reference and fast presets serve a floor-plan click through
`Workspace.render_image` on `assets/bench/synth_hier.npz`; the turbo preset
serves the room walkthrough pose of `chip_smoke.py` through
`NeRFRenderer.render_pose_uint8` on `assets/bench/room_proposal.npz` and its
`.turbo.npz` student, with the checkpoint's depth range.
"""

import argparse
import dataclasses
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


def _frame_fn(preset: str, precision: str):
    """A callable serving one warm frame to the host, uint8."""
    if preset != "turbo":
        from nerf_workspaces_explorer_tpu_torch.app.workspace import OfficeTokyoWorkspace

        office = OfficeTokyoWorkspace(
            ckpt_path=os.path.join(ROOT, "assets", "bench", "synth_hier.npz"), precision=precision, preset=preset
        )
        office.initialize_models()
        return lambda: office.render_image(0.5, 0.5, 0, 0)

    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.core.types import COORD
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    ckpt = os.path.join(ROOT, "assets", "bench", "room_proposal.npz")
    _, _, meta = load_checkpoint(ckpt)
    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering, depth_range=tuple(meta["depth_range"])))
    renderer = NeRFRenderer("tokyo", ckpt, config=cfg, precision=precision, preset="turbo")
    renderer.initialize_models()
    pose = poses_from_coordinates(COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0), [COORD(yaw=-30.0)])[0]
    return lambda: renderer.render_pose_uint8(pose).cpu().numpy()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=("reference", "fast", "turbo"), default="reference")
    parser.add_argument("--precision", choices=("fast", "int8", "int8-trunk"), default="fast")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    frame = _frame_fn(args.preset, args.precision)
    frame()  # warm-up: kernel build and first launches
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    kernels = [
        e for e in prof.key_averages()
        if _device_us(e) > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / FRAMES
    print(f"card: {card}")
    print(f"preset {args.preset}, precision {args.precision}: frame wall {wall_ms:.2f} ms, device "
          f"{device_ms:.2f} ms, device idle share {1.0 - device_ms / wall_ms:.3f} (over {FRAMES} frames)")
    if not kernels:
        print("no device time captured by the profiler")
    # The 15 longest kernels, then the placement kernel (K2/K6) wherever it ranks.
    ranked = sorted(kernels, key=_device_us, reverse=True)
    shown = ranked[:15] + [e for e in ranked[15:] if "importance_merge" in e.key]
    for e in shown:
        print(f"  {_device_us(e) / 1e3 / FRAMES:9.4f} ms/frame  x{e.count // FRAMES:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
