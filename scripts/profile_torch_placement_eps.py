#!/usr/bin/env python3
"""What the density pass's stop bound costs and buys at the fast preset, on a CUDA card.

`render_rays_fused` stops the density pass that feeds importance-only
placement at T <= `ops/fused_render.py::PLACEMENT_EPS` (1e-6), below the
renderer's early-stop eps (1e-3), because the kernel stops a whole 32-ray
block at once and the zeroed tail weights move the importance samples.
This script serves `assets/bench/synth_hier.npz` at the fast preset (bf16,
importance-only placement) on `chip_smoke.py`'s three clicks with that bound
set to 1e-6, 1e-5, 1e-4 and 1e-3, and prints for each click the frame's
difference from the eps-0 frame (mean and max |rgb|, share of values off
by more than 1e-2), the SSIM of the uint8 frame against the eps-0 and the
fp32 parity frames, and the warm ms per frame (host clock up to the
device-to-host copy, mean of 3). Run from the repository root:

    python3 scripts/profile_torch_placement_eps.py
"""

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3)
FRAMES = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    cfg = load_config(office_name="tokyo")
    poses = []
    for cls_name, *click in chip_smoke.CLICKS:
        init, coord = getattr(ws, cls_name)(ckpt_path=chip_smoke.CKPT, device=device).transform_relative_coordinates(
            *click)
        poses.append(poses_from_coordinates(init, [coord])[0])

    def renderer(precision, eps=1e-3):
        r = NeRFRenderer("tokyo", chip_smoke.CKPT, config=cfg, precision=precision, preset="fast", device=device,
                         early_stop_eps=eps)
        r.initialize_models()
        return r

    exact, parity = renderer("fast", 0.0), renderer("parity")
    ref = [exact.render_pose(p) for p in poses]
    ref8 = [exact.render_pose_uint8(p).cpu().numpy() / 255.0 for p in poses]
    par8 = [parity.render_pose_uint8(p).cpu().numpy() / 255.0 for p in poses]
    served = fr.PLACEMENT_EPS
    try:
        for bound in BOUNDS:
            fr.PLACEMENT_EPS = bound
            r = renderer("fast")
            for i, pose in enumerate(poses):
                d = (r.render_pose(pose) - ref[i]).abs()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FRAMES):
                    frame = r.render_pose_uint8(pose).cpu().numpy() / 255.0
                ms = (time.perf_counter() - t0) / FRAMES * 1e3
                print(f"density stop bound {bound:g}, click {i}: vs eps 0 mean |d| {float(d.mean()):.3e} max "
                      f"{float(d.max()):.3e} share > 1e-2 {float((d > 1e-2).float().mean()):.5f}; SSIM vs eps 0 "
                      f"{ssim(frame, ref8[i]):.5f} vs parity {ssim(frame, par8[i]):.5f}; warm ms/frame {ms:.1f}; "
                      f"card {card}", flush=True)
    finally:
        fr.PLACEMENT_EPS = served
    return 0


if __name__ == "__main__":
    sys.exit(main())
