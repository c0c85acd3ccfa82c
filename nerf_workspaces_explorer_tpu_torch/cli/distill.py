"""Distillation CLI of the port: a trained office checkpoint distilled into
the narrow student the turbo preset serves.

Counterpart of `nerf_workspaces_explorer_tpu/cli/distill.py`, with its flags
and defaults: renders the teacher at poses covering the office's reachable
view space (the calibration a floor-plan click goes through), trains a
proposal-mode student on those renders (`train/distill.py`) and writes a
`.turbo.npz` sidecar beside the teacher, which `NeRFRenderer(preset="turbo")`
of either package serves. Runs on `cuda` (the fused render kernels for the
views, the K4/K5 field kernels for the student) unless given `--device cpu`
(plain PyTorch).

Usage:
    python -m nerf_workspaces_explorer_tpu_torch.cli.distill --office tokyo \\
        [--ckpt path] [--steps 50000] [--width 192 --depth 6 --freqs 10]
    python -m nerf_workspaces_explorer_tpu_torch.cli.distill --office tokyo \\
        --ckpt model.npz --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

from nerf_workspaces_explorer_tpu_torch.train.distill import DEFAULT_DISTILL_STEPS, DEFAULT_STUDENT

OFFICES = ("tokyo", "new_york", "geneve", "belgrade")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--office", type=str, default="tokyo", choices=OFFICES)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="teacher checkpoint (.npz or torch .ckpt); default: the office's final model")
    # The student defaults are DEFAULT_STUDENT's (6x192@10f, 50k steps), the
    # recipe that holds interiors; `--depth 4 --width 128 --freqs 8` is the
    # speed student, to be gated per scene.
    parser.add_argument("--steps", type=int, default=DEFAULT_DISTILL_STEPS)
    parser.add_argument("--depth", type=int, default=DEFAULT_STUDENT["depth"])
    parser.add_argument("--width", type=int, default=DEFAULT_STUDENT["width"])
    parser.add_argument("--freqs", type=int, default=DEFAULT_STUDENT["num_freqs_3d"],
                        help="student positional-encoding frequencies")
    parser.add_argument("--grid", type=int, default=4, help="floor-plan lattice per axis for teacher views")
    parser.add_argument("--yaw-step", type=float, default=45.0)
    parser.add_argument("--view-scale", type=int, default=1,
                        help="divide the config H/W by this for teacher views")
    parser.add_argument("--n-importance-serving", type=int, default=48,
                        help="importance samples the turbo preset serves with")
    parser.add_argument("--prop-subsample-serving", type=int, default=4,
                        help="coarse/importance ray-lattice stride the turbo preset serves with")
    parser.add_argument("--n-samples", type=int, default=None,
                        help="uniform proposal-pass samples the student trains and serves with "
                        "(default: the teacher config's n_samples)")
    parser.add_argument("--out", type=str, default=None, help="sidecar path (default: <ckpt>.turbo.npz)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from nerf_workspaces_explorer_tpu_torch.app.workspace import _find_checkpoint
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint, load_torch_checkpoint
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import (
        resolve_device,
        settings_from_config,
        spec_from_config,
    )
    from nerf_workspaces_explorer_tpu_torch.train.distill import (
        distill_student,
        office_distill_poses,
        save_turbo_checkpoint,
        turbo_sidecar_path,
    )

    device = resolve_device(args.device)
    ckpt = args.ckpt or _find_checkpoint(args.office)
    if not os.path.exists(ckpt):
        raise RuntimeError(f"teacher checkpoint not found: {ckpt}")
    cfg = load_config(office_name=args.office)
    if ckpt.endswith(".ckpt"):
        coarse, fine, _ = load_torch_checkpoint(ckpt)
        teacher_params = {"coarse": coarse, "fine": fine}
    else:
        teacher_params, _, _ = load_checkpoint(ckpt)
    teacher_spec = spec_from_config(cfg)
    teacher_settings = settings_from_config(cfg).for_eval()
    if "proposal" in teacher_params:
        teacher_settings = teacher_settings._replace(use_proposal=True)

    h = cfg.experiment.image_height // args.view_scale
    w = cfg.experiment.image_width // args.view_scale
    near, far = cfg.rendering.depth_range
    poses = office_distill_poses(args.office, grid=args.grid, yaw_step_degrees=args.yaw_step)
    print(f"[distill] office={args.office} teacher={ckpt} {poses.shape[0]} views at {w}x{h}, student "
          f"{args.depth}x{args.width} @ {args.freqs} freqs, {args.steps} steps on {device}", flush=True)
    t0 = time.time()
    student_params, student_cfg, report = distill_student(
        teacher_params, teacher_spec, teacher_settings, poses,
        height=h, width=w, near=near, far=far, steps=args.steps,
        depth=args.depth, net_width=args.width, num_freqs_3d=args.freqs,
        name=f"distill_{args.office}", n_samples=args.n_samples, device=device,
    )
    out = args.out or turbo_sidecar_path(ckpt)
    save_turbo_checkpoint(
        out, student_params, student_cfg,
        n_importance_serving=args.n_importance_serving,
        proposal_subsample_serving=args.prop_subsample_serving,
        report=report, teacher=ckpt, step=args.steps,
    )
    print(f"[distill] done in {time.time() - t0:.0f}s: psnr_vs_teacher {report['psnr_vs_teacher']:.2f} dB "
          f"-> {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
