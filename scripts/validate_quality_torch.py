#!/usr/bin/env python3
"""End-to-end quality validation of the PyTorch port: train -> render ->
PSNR/SSIM against ground truth, on a CUDA card.

The port of `scripts/validate_quality.py`, with its flags, defaults,
thresholds, failure strings and report rows, plus `--device` (default
`cuda`; without a card it raises unless given `--device cpu`, where every
kernel runs its plain PyTorch version). It trains a NeRF on a synthetic
scene at the shipped office configuration (8x256 coarse+fine, 64+128
samples, 1024 rays/step), renders the held-out test views through the fused
serving path (`ops/fused_render.py::render_rays_fused`: on the card the
density pass K1, placement K2, the fine pass K3) and reports:
  - test PSNR/SSIM against ground truth (training quality),
  - SSIM between the fused render and the fp32 plain pipeline
    (`render/pipeline.py::render_rays_chunked`, chunk 4096) on the same
    trained weights (the >= 0.99 fidelity target),
  - the same check for the int8 serving mode (trunk + heads, K7).

With --proposal a second model trains in proposal mode (2x64 density net in
the coarse net's place) and must hold the same fidelity bars plus test PSNR
within --max-psnr-drop of the hierarchical run. --fast-preset measures the
importance-only fine pass (K6) at int8 for each --fast-n-importance count,
--prop-subsample N the same with placement on every Nth ray per axis. With
--turbo the gated leg's model is distilled into the narrow student
(`train/distill.py`, the `preset="turbo"` serving path), which must hold
test-vs-ground-truth PSNR within --max-turbo-psnr-drop of its teacher on
the same gate views, and the SSIM gates.

Each leg trains one step a call at every 500th step (the progress print)
and in `Trainer.step_many` calls of STEPS_PER_CALL steps between them: on
the card replays of a CUDA graph of those steps, whose losses equal the
eager steps' (the trajectory is the one-step-a-call loop's), on the CPU as
many eager steps.

This script is a GATE: it exits 1 when any threshold fails. Run from the
repository root:

    python3 scripts/validate_quality_torch.py --proposal --fast-preset --prop-subsample 4
    python3 scripts/validate_quality_torch.py --steps 20000 --proposal --fast-preset --turbo \\
        --prop-subsample 4 --report reports/quality_gate_torch_20k_defaults.md
    python3 scripts/validate_quality_torch.py --steps 0 --height 12 --width 16 --device cpu
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

PRINT_EVERY = 500  # the progress print's cadence, in steps
STEPS_PER_CALL = 10  # steps a Trainer.step_many call takes between prints


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return "the CPU (no card: each kernel ran its plain PyTorch version)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi failed"


def _psnr(rgb: np.ndarray, gt: np.ndarray) -> float:
    return float(-10 * np.log10(float(np.mean((rgb - gt) ** 2))))


def _load_params(trainer, params) -> None:
    """Copy a {net: {...}} tree (numpy or tensors) into the trainer's
    parameters, leaf for leaf."""
    import torch

    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves

    loaded = params_from_numpy({k: params[k] for k in trainer.params}, trainer._device)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(trainer.params), tree_leaves(loaded)):
            if dst.shape != src.shape:
                raise ValueError(f"leaf {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def train_leg(trainer, name: str, steps: int) -> float:
    """`steps` steps of the trainer (module docstring); returns seconds."""
    import torch

    start = time.time()
    i = 0
    while i < steps:
        boundary = min((i // PRINT_EVERY + 1) * PRINT_EVERY, steps)
        if i % PRINT_EVERY and boundary - i >= trainer.steps_per_call:
            trainer.step_many(i)
            i += trainer.steps_per_call
            continue
        metrics = trainer.step(i)
        if i % PRINT_EVERY == 0:
            print(f"[{name}] step {i}: loss {float(metrics['total_loss']):.5f} "
                  f"psnr_fine {float(metrics['psnr_fine']):.2f}", flush=True)
        i += 1
    if trainer._device.type == "cuda":
        torch.cuda.synchronize()
    return time.time() - start


def run_leg(name, use_proposal, train, test, cfg, args, params=None, seed=0):
    """Train one model and measure quality + fused/int8 fidelity (JAX
    `run_leg`). `params`: weights to start from in place of the trainer's
    seeded ones (a {net: {...}} tree of numpy arrays or tensors); `seed`
    the Trainer's (its initial weights and every step's draws)."""
    import torch

    from nerf_workspaces_explorer_tpu_torch.ops.fused_render import prepare_kernel_params, render_rays_fused
    from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_model_quant, spec_from_net_params
    from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import render_rays_chunked
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim, to8b
    from nerf_workspaces_explorer_tpu_torch.utils.png import write_png

    h, w = args.height, args.width
    trainer = Trainer(
        f"office_synth_validation_{name}",
        cfg,
        train_data=train,
        test_data=test,
        save_dir=os.path.join(args.out, f"run_{name}"),
        enable_tensorboard=False,
        use_proposal=use_proposal,
        steps_per_call=STEPS_PER_CALL,
        device=args.device,
        seed=seed,
    )
    trainer.setup()
    if params is not None:
        _load_params(trainer, params)

    train_time = train_leg(trainer, name, args.steps)
    print(f"[{name}] trained {args.steps} steps in {train_time:.0f}s "
          f"({args.steps / max(train_time, 1e-9):.1f} steps/s)")

    def image(out: torch.Tensor) -> np.ndarray:
        return out.reshape(h, w, 3).to(torch.float32).cpu().numpy()

    def view(i: int) -> RayBundle:
        return RayBundle(*(f[i] for f in trainer.rays_test)).reshape(h * w)

    # The fp32 reference pipeline and the kernels' parameters: bf16 (the
    # trained fp32 weights, as the JAX script hands them over) and int8
    # (trunk + heads) from one static calibration.
    eval_settings = trainer._settings.for_eval()._replace(field_impl="plain")
    kparams = {k: prepare_kernel_params(p, spec_from_net_params(p)) for k, p in trainer.params.items()}
    quant = calibrate_model_quant(trainer.params, trainer._spec, box=6.0)
    kparams_int8 = {
        k: prepare_kernel_params(p, spec_from_net_params(p), quant=quant[k]) for k, p in trainer.params.items()
    }

    psnrs, ssims = [], []
    rgb = gt = image_rays = None
    for i in range(len(test)):
        image_rays = view(i)
        rgb = image(render_rays_fused(kparams, image_rays, eval_settings))
        gt = test.rgb[i]
        psnrs.append(_psnr(rgb, gt))
        ssims.append(ssim(rgb, gt))
    psnr = float(np.mean(psnrs))
    print(f"[{name}] TEST fused-kernel renders ({len(test)} views): "
          f"PSNR {psnr:.2f} dB (min {np.min(psnrs):.2f}), "
          f"SSIM {np.mean(ssims):.4f} (min {np.min(ssims):.4f})")
    write_png(os.path.join(args.out, f"render_{name}.png"), to8b(rgb))
    write_png(os.path.join(args.out, "ground_truth.png"), to8b(gt))

    # chunk 4096 as the JAX script renders; a smaller frame takes one chunk
    # of its own size (the same rays, without the padding).
    out = render_rays_chunked(trainer.params, image_rays, eval_settings, spec=trainer._spec, chunk=min(4096, h * w))
    rgb_ref = image(out["rgb_fine"])
    fidelity = ssim(rgb, rgb_ref)
    print(f"[{name}] fused vs fp32 pipeline on trained weights: "
          f"max|err| {np.abs(rgb - rgb_ref).max():.2e}, SSIM {fidelity:.5f} "
          f"(target >= {args.min_fidelity})")

    rgb_int8 = image(render_rays_fused(kparams_int8, image_rays, eval_settings))
    fidelity_int8 = ssim(rgb_int8, rgb_ref)
    print(f"[{name}] int8 fused vs fp32 pipeline on trained weights: "
          f"max|err| {np.abs(rgb_int8 - rgb_ref).max():.2e}, "
          f"SSIM {fidelity_int8:.5f} (target >= {args.min_fidelity})")

    # The fast serving preset: importance-only fine pass at int8 over every
    # test view, exact and (with --prop-subsample) strided placement.
    fast = {}
    if args.fast_preset:
        for n_imp in args.fast_n_importance:
            fs = eval_settings._replace(merge_coarse=False, n_importance=n_imp)
            variants = [("", fs)]
            if args.prop_subsample > 1:
                variants.append(("_sub", fs._replace(proposal_subsample=args.prop_subsample)))
            fast[n_imp] = {}
            for suffix, vs in variants:
                f_psnrs, f_ssims = [], []
                for i in range(len(test)):
                    rgb_fast = image(render_rays_fused(kparams_int8, view(i), vs, grid_hw=(h, w)))
                    f_psnrs.append(_psnr(rgb_fast, test.rgb[i]))
                    f_ssims.append(ssim(rgb_fast, test.rgb[i]))
                fast[n_imp]["psnr" + suffix] = float(np.mean(f_psnrs))
                fast[n_imp]["ssim" + suffix] = float(np.mean(f_ssims))
                tag = f", prop_subsample={args.prop_subsample}" if suffix else ""
                print(
                    f"[{name}] FAST preset (importance-only, int8, "
                    f"n_importance={n_imp}{tag}): PSNR "
                    f"{fast[n_imp]['psnr' + suffix]:.2f} dB "
                    f"(merged {psnr:.2f}), SSIM "
                    f"{fast[n_imp]['ssim' + suffix]:.4f}"
                )
    return {
        "psnr": psnr,
        "psnr_min": float(np.min(psnrs)),
        "ssim": float(np.mean(ssims)),
        "ssim_min": float(np.min(ssims)),
        "fidelity": fidelity,
        "fidelity_int8": fidelity_int8,
        "fast": fast,
        "train_s": train_time,
        "trainer": trainer,
    }


def run_turbo_leg(leg, leg_name, train, test, args, scene_ctx):
    """Distill the leg's trained model into the narrow turbo student and
    measure it against real ground truth at the serving configuration (JAX
    `run_turbo_leg`): with --scene room on the held-out probe grid, which
    the teacher renders too (the teacher >= student ordering check); with
    --scene orbit on the held-out test views."""
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import settings_from_config
    from nerf_workspaces_explorer_tpu_torch.models.encoding import embedding_output_dim
    from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
    from nerf_workspaces_explorer_tpu_torch.train.distill import (
        distill_student,
        render_student_views,
        render_teacher_views,
    )
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim

    tr = leg["trainer"]
    h, w = args.height, args.width
    near, far = scene_ctx["near"], scene_ctx["far"]
    if scene_ctx.get("grid_poses") is not None:
        # Room: the walkthrough tour plus the off-tour coverage views; the
        # probe grid held out (the student never trains on a gate view).
        from nerf_workspaces_explorer_tpu_torch.data.synthetic import room_coverage_poses

        cover = room_coverage_poses(scene_ctx["half"])
        gate_poses = scene_ctx["grid_poses"]
        gate_gt = scene_ctx["grid_gt"]
        poses = np.concatenate([train.camera_pose, cover, gate_poses], axis=0)
        gate_tag = f"probe grid ({len(gate_poses)} views)"
    else:
        # Orbit: train poses + extra rings; the test views held out as the gate.
        from nerf_workspaces_explorer_tpu_torch.data.synthetic import orbit_poses

        extra = np.concatenate([
            orbit_poses(10, radius=2.3, height=0.3),
            orbit_poses(10, radius=2.6, height=0.55),
            orbit_poses(10, radius=2.45, height=0.75),
        ], axis=0)
        gate_poses = test.camera_pose
        gate_gt = test.rgb
        poses = np.concatenate([train.camera_pose, extra, test.camera_pose], axis=0)
        gate_tag = f"test views ({len(gate_poses)})"
    student_params, student_cfg, dreport = distill_student(
        tr.params, tr._spec, tr._settings, poses,
        height=h, width=w, near=near, far=far,
        steps=args.turbo_steps, depth=args.turbo_depth,
        net_width=args.turbo_width, num_freqs_3d=args.turbo_freqs,
        n_holdout=len(gate_poses), name=f"turbo_{leg_name}",
        n_samples=args.turbo_n_samples,
        save_dir=os.path.join(args.out, f"turbo_{leg_name}"), device=args.device,
    )
    print(
        f"[turbo] student {args.turbo_depth}x{args.turbo_width} @ "
        f"{args.turbo_freqs} freqs distilled from [{leg_name}] in "
        f"{args.turbo_steps} steps: PSNR vs teacher "
        f"{dreport['psnr_vs_teacher']:.2f} dB on held-out views"
    )
    spec = NerfMLPSpec(
        depth=args.turbo_depth,
        width=args.turbo_width,
        input_ch=embedding_output_dim(args.turbo_freqs),
        input_ch_views=embedding_output_dim(student_cfg.rendering.num_freqs_2d),
        use_view_dirs=True,
    )
    settings = settings_from_config(student_cfg).for_eval()._replace(
        use_proposal=True, merge_coarse=False, n_importance=args.turbo_n_importance,
    )

    def stats(frames):
        psnrs = np.array([_psnr(frames[i], gate_gt[i]) for i in range(len(gate_poses))])
        ssims = np.array([ssim(frames[i], gate_gt[i]) for i in range(len(gate_poses))])
        return psnrs, ssims

    rgb = render_student_views(student_params, spec, settings, gate_poses, h, w, near=near, far=far,
                               device=args.device)
    psnrs, ssims = stats(rgb)
    # The teacher's renders of the same gate views (merged placement, its
    # own serving quality) for the ordering check.
    teacher_rgb = render_teacher_views(tr.params, tr._spec, tr._settings, gate_poses, h, w, near=near, far=far,
                                       device=args.device)
    t_psnrs, t_ssims = stats(teacher_rgb)
    out = {
        "psnr": float(np.mean(psnrs)),
        "psnr_min": float(np.min(psnrs)),
        "ssim": float(np.mean(ssims)),
        "ssim_min": float(np.min(ssims)),
        "teacher_psnr": float(np.mean(t_psnrs)),
        "teacher_psnr_min": float(np.min(t_psnrs)),
        "teacher_ssim": float(np.mean(t_ssims)),
        "teacher_ssim_min": float(np.min(t_ssims)),
        "psnr_vs_teacher": float(dreport["psnr_vs_teacher"]),
        "gate_tag": gate_tag,
    }
    print(
        f"[turbo] {gate_tag} vs ground truth (serving config, "
        f"n_importance={args.turbo_n_importance}): student PSNR "
        f"{out['psnr']:.2f} dB (min {out['psnr_min']:.2f}), SSIM "
        f"{out['ssim']:.4f} (min {out['ssim_min']:.4f}); teacher PSNR "
        f"{out['teacher_psnr']:.2f} dB (min {out['teacher_psnr_min']:.2f})"
    )
    if args.prop_subsample > 1:
        rgb_sub = render_student_views(
            student_params, spec, settings._replace(proposal_subsample=args.prop_subsample),
            gate_poses, h, w, near=near, far=far, device=args.device,
        )
        s_psnrs, s_ssims = stats(rgb_sub)
        out["psnr_sub"] = float(np.mean(s_psnrs))
        out["psnr_sub_min"] = float(np.min(s_psnrs))
        out["ssim_sub"] = float(np.mean(s_ssims))
        print(
            f"[turbo] {gate_tag} vs ground truth (serving config, "
            f"prop_subsample={args.prop_subsample}): PSNR "
            f"{out['psnr_sub']:.2f} dB (exact placement {out['psnr']:.2f}), "
            f"SSIM {out['ssim_sub']:.4f}"
        )
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--out", type=str, default="/tmp/validate_quality")
    parser.add_argument(
        "--min-psnr", type=float, default=24.0,
        help="fail below this mean test PSNR (dB)",
    )
    parser.add_argument(
        "--min-fidelity", type=float, default=0.99,
        help="fail below this fused-vs-jnp SSIM (BASELINE.md target)",
    )
    parser.add_argument(
        "--proposal", action="store_true",
        help="also train + gate the proposal-mode serving path",
    )
    parser.add_argument(
        "--max-psnr-drop", type=float, default=0.7,
        help="--proposal: fail if the proposal run loses more test PSNR "
             "than this vs the hierarchical run (dB)",
    )
    parser.add_argument(
        "--fast-preset", action="store_true",
        help="also measure + gate the importance-only fast serving preset "
             "(merge_coarse=False) at each --fast-n-importance count",
    )
    parser.add_argument(
        "--fast-n-importance", type=int, nargs="+", default=[128, 96],
        help="--fast-preset: importance-only sample counts to evaluate",
    )
    parser.add_argument(
        "--max-fast-psnr-drop", type=float, default=0.5,
        help="--fast-preset: fail if the LARGEST gated fast count loses "
             "more test PSNR than this vs the same leg's merged render (dB)",
    )
    parser.add_argument(
        "--turbo", action="store_true",
        help="also distill + gate the narrow turbo student "
             "(train/distill.py; served by NeRFRenderer preset='turbo')",
    )
    # The turbo student's defaults are train/distill.py's DEFAULT_STUDENT
    # and DEFAULT_DISTILL_STEPS (tests/test_torch_quality_gate.py).
    from nerf_workspaces_explorer_tpu_torch.train.distill import DEFAULT_DISTILL_STEPS, DEFAULT_STUDENT

    parser.add_argument("--turbo-steps", type=int, default=DEFAULT_DISTILL_STEPS)
    parser.add_argument("--turbo-depth", type=int, default=DEFAULT_STUDENT["depth"])
    parser.add_argument("--turbo-width", type=int, default=DEFAULT_STUDENT["width"])
    parser.add_argument("--turbo-freqs", type=int, default=DEFAULT_STUDENT["num_freqs_3d"])
    parser.add_argument(
        "--turbo-n-importance", type=int, default=48,
        help="--turbo: importance samples the student serves with",
    )
    parser.add_argument(
        "--turbo-n-samples", type=int, default=None,
        help="--turbo: uniform proposal-pass samples the student trains "
        "and serves with (default: the teacher's n_samples)",
    )
    parser.add_argument(
        "--prop-subsample", type=int, default=0,
        help="also measure + gate proposal_subsample=N (coarse/importance "
             "stage on every Nth ray per axis; fast-preset and turbo legs)",
    )
    parser.add_argument(
        "--max-subsample-psnr-drop", type=float, default=0.3,
        help="--prop-subsample: fail if the subsampled placement loses more "
             "test PSNR than this vs the same config's exact placement (dB)",
    )
    parser.add_argument(
        "--max-turbo-psnr-drop", type=float, default=1.0,
        help="--turbo: fail if the student loses more test-vs-ground-truth "
             "PSNR than this vs its teacher leg's merged render (dB)",
    )
    # The SSIM gates, calibrated by the JAX package on its passing room
    # report (mean SSIM drop vs teacher 0.0111, worst view 0.7811 against
    # the teacher's 0.7871; the failing 4x128 recipe sat at 0.0545 / 0.7199).
    parser.add_argument(
        "--max-turbo-ssim-drop", type=float, default=0.03,
        help="--turbo: fail if the student's mean SSIM on the gate views "
             "falls more than this below the teacher's",
    )
    parser.add_argument(
        "--min-turbo-ssim-ratio", type=float, default=0.92,
        help="--turbo: fail if the student's WORST gate view drops below "
             "this fraction of the teacher's worst-view SSIM",
    )
    parser.add_argument(
        "--report", type=str, default=None, metavar="MD_PATH",
        help="also write the measured table as a markdown report "
             "(e.g. reports/quality_gate_20k.md)",
    )
    parser.add_argument(
        "--scene", choices=("orbit", "room"), default="orbit",
        help="orbit: the legacy 12-view blob orbit; room: the "
             "reference-scale interior walkthrough (~180 train views, "
             "reference split rule — data/synthetic.py RoomScene)",
    )
    parser.add_argument(
        "--room-frames", type=int, default=900,
        help="--scene room: walkthrough trajectory length (reference "
             "Sequence_1 is ~900 frames)",
    )
    parser.add_argument(
        "--room-stride", type=int, default=5,
        help="--scene room: train ids = every Nth frame (reference: 5)",
    )
    parser.add_argument(
        "--eval-views", type=int, default=0,
        help="evenly subsample the test split to N views for eval renders "
             "(0 = all; training always sees the full train split)",
    )
    parser.add_argument(
        "--grid", type=int, default=3,
        help="--scene room + --turbo: probe-grid positions per axis for "
             "the held-out distillation gate (x 4 yaw headings)",
    )
    parser.add_argument(
        "--cache-dir", type=str, default="/tmp/room_scene_cache",
        help="--scene room: ground-truth render cache directory",
    )
    parser.add_argument(
        "--max-turbo-over-teacher", type=float, default=0.3,
        help="--turbo: fail if the student BEATS its teacher by more than "
             "this on the gate views (dB) — a gate that ranks the student "
             "above the teacher on held-out views is insensitive",
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def gate_failures(args, hier, prop=None, turbo=None) -> list:
    """The gate's failure strings for the legs' numbers (JAX `main`'s
    checks, its strings and order); prints the per-gate lines."""
    failures = []
    if hier["psnr"] < args.min_psnr:
        failures.append(
            f"test PSNR {hier['psnr']:.2f} dB < required {args.min_psnr}"
        )
    if hier["fidelity"] < args.min_fidelity:
        failures.append(
            f"fused-vs-jnp SSIM {hier['fidelity']:.5f} < required {args.min_fidelity}"
        )
    if hier["fidelity_int8"] < args.min_fidelity:
        failures.append(
            f"int8-vs-jnp SSIM {hier['fidelity_int8']:.5f} < required {args.min_fidelity}"
        )
    if prop is not None:
        if prop["psnr"] < hier["psnr"] - args.max_psnr_drop:
            failures.append(
                f"proposal test PSNR {prop['psnr']:.2f} dB more than "
                f"{args.max_psnr_drop} dB below hierarchical {hier['psnr']:.2f}"
            )
        if prop["fidelity"] < args.min_fidelity:
            failures.append(
                f"proposal fused-vs-jnp SSIM {prop['fidelity']:.5f} "
                f"< required {args.min_fidelity}"
            )
        if prop["fidelity_int8"] < args.min_fidelity:
            failures.append(
                f"proposal int8-vs-jnp SSIM {prop['fidelity_int8']:.5f} "
                f"< required {args.min_fidelity}"
            )
    if args.fast_preset:
        # Gated on the proposal leg when present (the serving
        # configuration), else the hierarchical; only the largest sample
        # count is a hard gate.
        leg = prop if prop is not None else hier
        leg_name = "prop" if prop is not None else "hier"
        gate_n = max(args.fast_n_importance)
        drop = leg["psnr"] - leg["fast"][gate_n]["psnr"]
        print(
            f"fast-preset gate [{leg_name}, n_importance={gate_n}]: "
            f"PSNR drop {drop:+.2f} dB (allowed {args.max_fast_psnr_drop})"
        )
        if drop > args.max_fast_psnr_drop:
            failures.append(
                f"fast preset (n_importance={gate_n}) loses {drop:.2f} dB "
                f"> allowed {args.max_fast_psnr_drop} vs merged placement"
            )
        if args.prop_subsample > 1:
            sub_drop = leg["fast"][gate_n]["psnr"] - leg["fast"][gate_n]["psnr_sub"]
            print(
                f"prop-subsample gate [{leg_name}, fast n_importance="
                f"{gate_n}, s={args.prop_subsample}]: PSNR drop "
                f"{sub_drop:+.2f} dB (allowed {args.max_subsample_psnr_drop})"
            )
            if sub_drop > args.max_subsample_psnr_drop:
                failures.append(
                    f"prop_subsample={args.prop_subsample} loses "
                    f"{sub_drop:.2f} dB > allowed "
                    f"{args.max_subsample_psnr_drop} vs exact placement"
                )
    if turbo is not None:
        # The teacher rendered the same gate views: a like-for-like drop.
        drop = turbo["teacher_psnr"] - turbo["psnr"]
        print(
            f"turbo gate [{args.turbo_depth}x{args.turbo_width}@"
            f"{args.turbo_freqs}f, n_importance={args.turbo_n_importance}, "
            f"{turbo['gate_tag']}]: PSNR drop {drop:+.2f} dB vs teacher on "
            f"the gate views (allowed {args.max_turbo_psnr_drop}; "
            f"student-above-teacher allowed {args.max_turbo_over_teacher})"
        )
        if drop > args.max_turbo_psnr_drop:
            failures.append(
                f"turbo student loses {drop:.2f} dB > allowed "
                f"{args.max_turbo_psnr_drop} vs its teacher on the gate views"
            )
        if -drop > args.max_turbo_over_teacher:
            failures.append(
                f"turbo student BEATS its teacher by {-drop:.2f} dB > "
                f"{args.max_turbo_over_teacher} on held-out gate views — "
                "the gate is not ranking teacher above student "
                "(insensitive; round-3 VERDICT weak item 3)"
            )
        # Structure: PSNR alone can pass a student that smears texture.
        ssim_drop = turbo["teacher_ssim"] - turbo["ssim"]
        ssim_min_floor = args.min_turbo_ssim_ratio * turbo["teacher_ssim_min"]
        print(
            f"turbo SSIM gate: mean drop {ssim_drop:+.4f} vs teacher "
            f"(allowed {args.max_turbo_ssim_drop}); worst view "
            f"{turbo['ssim_min']:.4f} (floor {ssim_min_floor:.4f} = "
            f"{args.min_turbo_ssim_ratio} x teacher min "
            f"{turbo['teacher_ssim_min']:.4f})"
        )
        if ssim_drop > args.max_turbo_ssim_drop:
            failures.append(
                f"turbo student mean SSIM {turbo['ssim']:.4f} is "
                f"{ssim_drop:.4f} below teacher {turbo['teacher_ssim']:.4f} "
                f"> allowed {args.max_turbo_ssim_drop}"
            )
        if turbo["ssim_min"] < ssim_min_floor:
            failures.append(
                f"turbo student worst-view SSIM {turbo['ssim_min']:.4f} < "
                f"floor {ssim_min_floor:.4f} "
                f"({args.min_turbo_ssim_ratio} x teacher min)"
            )
        if args.prop_subsample > 1 and "psnr_sub" in turbo:
            sub_drop = turbo["psnr"] - turbo["psnr_sub"]
            print(
                f"prop-subsample gate [turbo, s={args.prop_subsample}]: "
                f"PSNR drop {sub_drop:+.2f} dB "
                f"(allowed {args.max_subsample_psnr_drop})"
            )
            if sub_drop > args.max_subsample_psnr_drop:
                failures.append(
                    f"turbo prop_subsample={args.prop_subsample} loses "
                    f"{sub_drop:.2f} dB > allowed "
                    f"{args.max_subsample_psnr_drop} vs exact placement"
                )
    return failures


def report_rows(args, hier, prop=None, turbo=None) -> str:
    """The report's table rows and turbo-gates line (JAX's, row for row)."""
    rows = []
    for leg_name, leg in (("hier", hier), ("prop", prop)):
        if leg is None:
            continue
        rows.append(
            f"| {leg_name} | merged placement | {leg['psnr']:.2f} "
            f"| {leg['psnr_min']:.2f} | {leg['ssim']:.4f} "
            f"| {leg['ssim_min']:.4f} | {leg['fidelity']:.5f} "
            f"| {leg['fidelity_int8']:.5f} |\n"
        )
        for n_imp, row in sorted(leg["fast"].items(), reverse=True):
            rows.append(
                f"| {leg_name} | fast preset, int8, "
                f"n_importance={n_imp} | {row['psnr']:.2f} "
                f"| — | {row['ssim']:.4f} | — | — | — |\n"
            )
            if "psnr_sub" in row:
                rows.append(
                    f"| {leg_name} | fast preset, int8, "
                    f"n_importance={n_imp}, prop_subsample="
                    f"{args.prop_subsample} | {row['psnr_sub']:.2f} "
                    f"| — | {row['ssim_sub']:.4f} | — | — | — |\n"
                )
    if turbo is not None:
        rows.append(
            f"| turbo | distilled {args.turbo_depth}x"
            f"{args.turbo_width}@{args.turbo_freqs}f student, "
            f"n_importance={args.turbo_n_importance}, "
            f"{turbo['gate_tag']} | {turbo['psnr']:.2f} "
            f"| {turbo['psnr_min']:.2f} | {turbo['ssim']:.4f} "
            f"| {turbo['ssim_min']:.4f} | — | — |\n"
        )
        rows.append(
            f"| turbo | TEACHER on the same gate views (merged "
            f"placement) | {turbo['teacher_psnr']:.2f} "
            f"| {turbo['teacher_psnr_min']:.2f} "
            f"| {turbo['teacher_ssim']:.4f} "
            f"| {turbo['teacher_ssim_min']:.4f} | — | — |\n"
        )
        if "psnr_sub" in turbo:
            rows.append(
                f"| turbo | same student, prop_subsample="
                f"{args.prop_subsample} | {turbo['psnr_sub']:.2f} "
                f"| {turbo['psnr_sub_min']:.2f} "
                f"| {turbo['ssim_sub']:.4f} | — | — | — |\n"
            )
        rows.append(
            f"\nTurbo gates: PSNR drop vs teacher <= "
            f"{args.max_turbo_psnr_drop} dB; mean SSIM drop vs "
            f"teacher <= {args.max_turbo_ssim_drop} (measured "
            f"{turbo['teacher_ssim'] - turbo['ssim']:+.4f}); "
            f"worst-view SSIM >= {args.min_turbo_ssim_ratio} x "
            f"teacher worst view (floor "
            f"{args.min_turbo_ssim_ratio * turbo['teacher_ssim_min']:.4f}, "
            f"measured {turbo['ssim_min']:.4f}).\n"
        )
    return "".join(rows)


def command_line(args) -> str:
    """The command that reproduces the run, with the flags that differ from
    the defaults the report's table depends on."""
    return (
        f"python3 scripts/validate_quality_torch.py --steps {args.steps}"
        + (f" --scene {args.scene}" if args.scene != "orbit" else "")
        + (" --proposal" if args.proposal else "")
        + (" --fast-preset" if args.fast_preset else "")
        + (" --turbo" if args.turbo else "")
        + (f" --turbo-steps {args.turbo_steps}" if args.turbo and args.turbo_steps != build_parser().get_default(
            "turbo_steps") else "")
        + (f" --prop-subsample {args.prop_subsample}" if args.prop_subsample > 1 else "")
        + (f" --eval-views {args.eval_views}" if args.eval_views > 0 else "")
        + (f" --height {args.height} --width {args.width}" if (args.height, args.width) != (96, 128) else "")
    )


def write_report(path, args, hier, prop, turbo, failures, n_train, n_test, card, notes="") -> None:
    """The markdown report: header (command, scene, the device the renders
    went through), JAX's table rows, the result."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    scene_desc = (
        f"room walkthrough (reference regime: every "
        f"{args.room_stride}th of {args.room_frames} frames -> "
        f"{n_train} train / {n_test} eval test views)"
        if args.scene == "room"
        else "blob orbit, 12 train / 3 test views"
    )
    with open(path, "w") as f:
        f.write(
            f"# Serving quality gate of the PyTorch port at {args.steps} steps\n\n"
            f"Command: `{command_line(args)}`. Scene: {args.height}x{args.width} {scene_desc}; "
            "shipped office model config. Test renders went through the port's fused "
            "serving path (`ops/fused_render.py::render_rays_fused`: density pass K1, "
            "placement K2 or importance-only K6, fine pass K3, int8 K7) and the "
            "fidelity reference through the fp32 plain pipeline, on "
            f"{card}.\n\n"
            + (notes + "\n\n" if notes else "")
            + "| leg | config | test PSNR (dB) | min | SSIM | min "
            "| fused-vs-jnp SSIM | int8-vs-jnp SSIM |\n"
            "|---|---|---|---|---|---|---|---|\n"
        )
        f.write(report_rows(args, hier, prop, turbo))
        f.write(
            "\nResult: "
            + ("**QUALITY GATE FAILED**: " + "; ".join(failures)
               if failures else "**QUALITY GATE PASSED.**")
            + "\n"
        )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from nerf_workspaces_explorer_tpu_torch.core.config import (
        ExperimentConfig,
        FrameworkConfig,
        LoggingConfig,
        RenderingConfig,
    )
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import resolve_device

    device = args.device = resolve_device(torch.device(args.device))
    card = card_line(device)
    print(f"device: {device}; {card}", flush=True)
    h, w = args.height, args.width
    if args.scene == "room":
        from nerf_workspaces_explorer_tpu_torch.data.synthetic import (
            make_room_scene_splits,
            render_room_ground_truth,
            room_grid_poses,
        )

        near, far = 0.1, 8.0
        train, test, scene = make_room_scene_splits(
            n_frames=args.room_frames, stride=args.room_stride,
            height=h, width=w, near=near, far=far,
            cache_dir=args.cache_dir, device=device,
        )
        print(
            f"scene: room walkthrough, {len(train)} train / {len(test)} "
            f"test views at {w}x{h}", flush=True,
        )
        scene_ctx = {"near": near, "far": far, "half": np.asarray(scene.half)}
        if args.turbo:
            grid_poses = room_grid_poses(half=np.asarray(scene.half), grid=args.grid)
            grid_gt, _ = render_room_ground_truth(
                scene, grid_poses, h, w, near=near, far=far,
                cache_dir=args.cache_dir, device=device,
            )
            scene_ctx["grid_poses"] = grid_poses
            scene_ctx["grid_gt"] = grid_gt
    else:
        near, far = 0.1, 6.0
        train, test, _ = make_synthetic_scene(n_train=12, n_test=3, height=h, width=w, device=device)
        scene_ctx = {"near": near, "far": far}
    if args.eval_views > 0 and args.eval_views < len(test):
        ids = np.linspace(0, len(test) - 1, args.eval_views).astype(int)
        test = type(test)(rgb=test.rgb[ids], depth=test.depth[ids], camera_pose=test.camera_pose[ids])
        print(f"eval subsampled to {len(test)} test views", flush=True)
    cfg = FrameworkConfig(
        experiment=ExperimentConfig(image_width=w, image_height=h),
        rendering=RenderingConfig(depth_range=(near, far)),
        logging=LoggingConfig(
            step_log_print=0,
            step_log_tensorboard=2**31 - 1,
            step_save_ckpt=0,
            step_render_test=0,
            step_render_train=0,
        ),
    )
    os.makedirs(args.out, exist_ok=True)

    hier = run_leg("hier", False, train, test, cfg, args)
    prop = run_leg("prop", True, train, test, cfg, args) if args.proposal else None
    turbo = None
    if args.turbo:
        teacher_leg, teacher_name = (prop, "prop") if prop is not None else (hier, "hier")
        turbo = run_turbo_leg(teacher_leg, teacher_name, train, test, args, scene_ctx)

    failures = gate_failures(args, hier, prop, turbo)
    if args.report:
        write_report(args.report, args, hier, prop, turbo, failures, len(train), len(test), card)
        print(f"report -> {args.report}")
    if failures:
        print("QUALITY GATE FAILED: " + "; ".join(failures))
        return 1
    print("QUALITY GATE PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
