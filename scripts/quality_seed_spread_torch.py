#!/usr/bin/env python3
"""Run-to-run spread of the quality gate's legs on a CUDA card.

Trains the gate's hierarchical and proposal legs
(`scripts/validate_quality_torch.py::run_leg`, its scene and config) once
per Trainer seed (initial weights and every step's draws) and prints each
leg's test PSNR/SSIM through the fused kernels and the proposal-minus-
hierarchical gap, the number the gate's `--max-psnr-drop` holds. Flags are
the gate's, plus `--seeds`. Run from the repository root:

    python3 scripts/quality_seed_spread_torch.py --steps 3000 --seeds 0 1 2
    python3 scripts/quality_seed_spread_torch.py --steps 0 --height 12 --width 16 --device cpu --seeds 0 1
"""

import os
import sys

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402
import validate_quality_torch as vq  # noqa: E402


def orbit_scene(args):
    """The gate's orbit scene and config: (train, test, cfg)."""
    from nerf_workspaces_explorer_tpu_torch.core.config import (
        ExperimentConfig,
        FrameworkConfig,
        LoggingConfig,
        RenderingConfig,
    )
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene

    h, w = args.height, args.width
    train, test, _ = make_synthetic_scene(n_train=12, n_test=3, height=h, width=w, device=args.device)
    cfg = FrameworkConfig(
        experiment=ExperimentConfig(image_width=w, image_height=h),
        rendering=RenderingConfig(depth_range=(0.1, 6.0)),
        logging=LoggingConfig(step_log_print=0, step_log_tensorboard=2**31 - 1, step_save_ckpt=0,
                              step_render_test=0, step_render_train=0),
    )
    return train, test, cfg


def spread(args, seeds, train, test, cfg) -> list:
    """Both legs once per seed; prints a line a seed and returns
    [{"seed", "hier", "prop", "gap"}] (gap: prop - hier test PSNR)."""
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for seed in seeds:
        legs = {name: vq.run_leg(name, name == "prop", train, test, cfg, args, seed=seed)
                for name in ("hier", "prop")}
        gap = legs["prop"]["psnr"] - legs["hier"]["psnr"]
        rows.append({"seed": seed, **legs, "gap": gap})
        print(f"spread seed {seed}: " + "; ".join(
            f"{name} PSNR {leg['psnr']:.2f} dB (views {leg['psnr_min']:.2f} min), SSIM {leg['ssim']:.4f}, "
            f"{args.steps} steps in {leg['train_s']:.1f} s" for name, leg in legs.items())
            + f"; prop - hier {gap:+.2f} dB (gate: > -{args.max_psnr_drop})", flush=True)
    return rows


def main(argv=None) -> int:
    parser = vq.build_parser()
    parser.description = __doc__
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args(argv)

    import torch

    from nerf_workspaces_explorer_tpu_torch.infer.renderer import resolve_device

    args.device = resolve_device(torch.device(args.device))
    print(f"device: {args.device}; {vq.card_line(args.device)}", flush=True)
    gaps = [r["gap"] for r in spread(args, args.seeds, *orbit_scene(args))]
    print(f"spread over seeds {args.seeds}: prop - hier {np.mean(gaps):+.2f} dB mean, "
          f"{min(gaps):+.2f} .. {max(gaps):+.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
