#!/usr/bin/env python3
"""What the fast preset's density-pass stop costs and buys, on a CUDA card.

At the fast preset the density pass's weights feed importance-only
placement. `render_rays_fused` passes the caller's early-stop eps to that
pass with `importance_only`, and the kernel then stops a 32-ray block only
once every ray has T <= min(eps, 1e-5 / S) (csrc/fused_render.cu: tail
weights under what the pdf's 1e-5 guard resolves). This script serves
`assets/bench/synth_hier.npz` at the fast preset (bf16) on `chip_smoke.py`'s
three clicks and prints, for each click:

  - from the eps-0 density weights: how many of the JAX package's 4,096-ray
    tiles would stop at each eps under its rule (every ray at T <= eps at an
    8-sample group boundary; a padded tile never stops) and how many rays
    they stop with T above the guarded bound, and how many of the port's
    32-ray blocks stop at eps and at the guarded bound;
  - for eps 1e-3 and 1e-4, with the guard (served) and without it (the
    density pass stopped at eps itself): the frame's difference from the
    eps-0 frame (mean and max |rgb|, share of values off by more than
    1e-2), the SSIM of the uint8 frame against the eps-0 and the fp32 parity
    frames, the samples both passes evaluated and the warm ms per frame
    (host clock up to the device-to-host copy, mean of 3).

Run from the repository root:

    python3 scripts/profile_torch_placement_eps.py
"""

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = (1e-3, 1e-4)
FRAMES = 3
JAX_TILE, JAX_GROUP = 4096, 8  # pallas_render.py DEFAULT_RAY_TILE; its 8-sample groups at 64 samples
PDF_GUARD = 1e-5


def transmittance(weights_t: torch.Tensor) -> torch.Tensor:
    """[S, R] compositing weights -> [S, R] transmittance after each sample
    (1 - the running sum of weights, in float64)."""
    return 1.0 - torch.cumsum(weights_t.double(), 0)


def jax_tile_stops(weights_t: torch.Tensor, eps: float, tile: int = JAX_TILE, group: int = JAX_GROUP) -> tuple:
    """(tiles that stop, tiles, rays that stop with T above the guarded bound
    1e-5 / S) under the JAX kernel's rule: a tile stops at the first group
    boundary where all its rays have T <= eps, and zeroes their tails;
    padding rays (T = 1) keep the last, partial tile alive."""
    trans = transmittance(weights_t)[group - 1 : -1 : group]  # T at each later group's start
    n_rays = trans.shape[1]
    n_tiles = -(-n_rays // tile)
    bound = PDF_GUARD / weights_t.shape[0]
    stops = above = 0
    for i in range(n_tiles):
        t = trans[:, i * tile : (i + 1) * tile]
        done = (t.amax(1) <= eps).nonzero()
        if t.shape[1] == tile and len(done):
            stops += 1
            above += int((t[int(done[0])] > bound).sum())
    return stops, n_tiles, above


def block_stops(weights_t: torch.Tensor, bound: float, block: int = 32, step: int = 4) -> tuple:
    """(blocks that stop, blocks) of the port's kernel at a T bound."""
    trans = transmittance(weights_t)[step - 1 : -1 : step]
    n = trans.shape[1] // block * block
    t = trans[:, :n].reshape(trans.shape[0], -1, block).amax(2)
    return int((t <= bound).any(0).sum()), t.shape[1]


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
    from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals
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
    n_samples = exact.settings.n_samples
    for i, pose in enumerate(poses):
        rays = exact._rays([pose])
        kp = exact.kernel_params["coarse"]
        o_ph, d_ph = fr.ray_phase_vectors(rays.origins, rays.dirs, kp.pts_freqs)
        z = coarse_z_vals(rays.near, rays.far, n_samples).T.contiguous()
        w = fr.nerf_render(kp, o_ph, d_ph, z, fr._dists_from_z(z, torch.linalg.norm(rays.dirs, dim=-1)[None]),
                           density_only=True, early_stop_eps=0.0)
        for eps in EPS:
            tiles = jax_tile_stops(w, eps)
            guarded, plain = block_stops(w, min(eps, PDF_GUARD / n_samples)), block_stops(w, eps)
            print(f"click {i}, eps {eps:g}: JAX 4096-ray tiles stopping {tiles[0]} of {tiles[1]}, with "
                  f"{tiles[2]} of {w.shape[1]} rays above the guarded bound where their tile stops; port 32-ray "
                  f"blocks stopping at the guarded bound {guarded[0]} of {guarded[1]}, at eps {plain[0]}",
                  flush=True)

    served = fr.nerf_render

    def unguarded(*args, **kw):
        kw["importance_only"] = False
        return served(*args, **kw)

    try:
        for eps in EPS:
            for guard in (True, False):
                fr.nerf_render = served if guard else unguarded
                r = renderer("fast", eps)
                for i, pose in enumerate(poses):
                    d = (r.render_pose(pose) - ref[i]).abs()
                    live = torch.zeros(1, dtype=torch.int32, device=device)
                    fr.render_rays_fused(r.kernel_params, r._rays([pose]), r.settings, early_stop_eps=eps,
                                         live_groups=live)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(FRAMES):
                        frame = r.render_pose_uint8(pose).cpu().numpy() / 255.0
                    ms = (time.perf_counter() - t0) / FRAMES * 1e3
                    print(f"eps {eps:g}, {'guarded (served)' if guard else 'unguarded'}, click {i}: vs eps 0 mean "
                          f"|d| {float(d.mean()):.3e} max {float(d.max()):.3e} share > 1e-2 "
                          f"{float((d > 1e-2).float().mean()):.5f}; SSIM vs eps 0 {ssim(frame, ref8[i]):.5f} vs "
                          f"parity {ssim(frame, par8[i]):.5f}; samples evaluated (both passes) "
                          f"{int(live) * fr.STEP_POINTS}; warm ms/frame {ms:.1f}; card {card}", flush=True)
    finally:
        fr.nerf_render = served
    return 0


if __name__ == "__main__":
    sys.exit(main())
