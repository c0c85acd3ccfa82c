#!/usr/bin/env python3
"""Long-horizon (>= 20k step) training study of the PyTorch port, with the
nine published training curves, on a CUDA card.

The port of `scripts/long_horizon_study.py`. One synthetic-scene training
run per mode, each a `python -m nerf_workspaces_explorer_tpu_torch.cli.train`
subprocess at `--steps-per-call 100` (on the card replays of a CUDA graph
of 100 steps between the cadence boundaries):
  plain     `--field plain`: fp32 PyTorch field (the JAX study's `xla`)
  fused     `--field fused`: the K4/K5 CUDA kernels, bf16 products with
            fp32 accumulation (the JAX study's `pallas`; the drift under test)
  proposal  `--proposal`: 2x64 proposal density net + interlevel loss, on
            the default field (fused on the card; the JAX study's `proposal`)

then copies each run's nine SVG curves into reports/curves_torch_<tag>/<mode>/
and writes a final-metrics summary to reports/long_horizon_torch_<tag>.md.
The final metrics are the last values of each run's scalar history, read
through `obs/export.py::scalars_from_tensorboard_logs` (TensorBoard event
files, or the port's scalar sink where `tensorboard` is not installed). The
fused - plain final test PSNR is the bf16-gradient drift: |drift| >
--max-bf16-drift-db exits 1. Runs on `cuda` unless given `--device cpu`.

    python3 scripts/long_horizon_study_torch.py [--steps 20000]
    python3 scripts/long_horizon_study_torch.py --scene room --size 320 --steps 200000

`--config` hands a config YAML (reference schema) to every run in place of
the office's, e.g. narrow nets and a short test-render cadence for a CPU
run of seconds.
"""

import argparse
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from validate_quality_torch import card_line  # noqa: E402

# Mode -> its training flags. The proposal run keeps the default field: the
# shipped training configuration.
MODES = {
    "plain": ["--field", "plain"],
    "fused": ["--field", "fused"],
    "proposal": ["--proposal"],
}


def run_mode(mode: str, extra, steps: int, base: str, args) -> str:
    save_dir = os.path.join(base, mode)
    if args.scene == "room":
        scene_args = [
            "--scene", "room", "--synthetic-size", str(args.size),
            "--room-frames", str(args.room_frames),
            "--room-stride", str(args.room_stride),
            "--scene-cache", args.cache_dir,
        ]
    else:
        # 12 train views (the quality gate's scene): the CLI's default 8
        # overfit long runs in the JAX study.
        scene_args = ["--synthetic-size", str(args.size), "--synthetic-views", "12", "3"]
    cmd = [
        sys.executable, "-u", "-m", "nerf_workspaces_explorer_tpu_torch.cli.train",
        "--office", "tokyo", "--synthetic", *scene_args,
        "--iterations", str(steps), "--steps-per-call", "100",
        "--save-dir", save_dir, "--save-final", "--device", args.device, *extra,
    ]
    if args.eval_max_views > 0:
        cmd += ["--eval-max-views", str(args.eval_max_views)]
    if args.config:
        cmd += ["--config", args.config]
    log_path = os.path.join(base, f"{mode}.log")
    print(f"[{mode}] {' '.join(cmd)} (log: {log_path})", flush=True)
    t0 = time.time()
    with open(log_path, "w") as log:
        result = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
    print(f"[{mode}] exit {result.returncode} in {time.time() - t0:.0f}s", flush=True)
    if result.returncode != 0:
        with open(log_path) as log:
            print(log.read()[-3000:])
        raise RuntimeError(f"{mode} training run failed")
    return save_dir


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=20000)
    parser.add_argument("--base", type=str, default=None)
    parser.add_argument("--reports", type=str, default=os.path.join(REPO, "reports"))
    parser.add_argument("--max-bf16-drift-db", type=float, default=1.0)
    parser.add_argument(
        "--scene", choices=("orbit", "room"), default="orbit",
        help="orbit: 12-view blob orbit at --size 128; room: "
        "reference-scale walkthrough (use --size 320 for the reference's "
        "320x240)",
    )
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--room-frames", type=int, default=900)
    parser.add_argument("--room-stride", type=int, default=5)
    parser.add_argument("--cache-dir", type=str, default="/tmp/room_scene_cache")
    parser.add_argument(
        "--eval-max-views", type=int, default=0,
        help="subsample eval render cadences to N views (0 = render all; "
        "see cli.train --eval-max-views)",
    )
    parser.add_argument(
        "--modes", nargs="+", default=list(MODES), choices=list(MODES),
        help="subset of training modes to run (default: all three)",
    )
    parser.add_argument("--config", type=str, default=None,
                        help="config YAML (reference schema) for every run, in place of the office's")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from nerf_workspaces_explorer_tpu_torch.infer.renderer import resolve_device
    from nerf_workspaces_explorer_tpu_torch.obs.export import scalars_from_tensorboard_logs

    args.device = str(resolve_device(torch.device(args.device)))
    card = card_line(args.device)
    tag = f"{args.steps // 1000}k" + ("_room" if args.scene == "room" else "")
    if args.base is None:
        args.base = f"/tmp/long_horizon_torch_{tag}"
    os.makedirs(args.base, exist_ok=True)

    summaries = {}
    for mode in args.modes:
        save_dir = run_mode(mode, MODES[mode], args.steps, args.base, args)

        # The nine exported SVGs, as the checked-in artifact.
        curves_src = os.path.join(save_dir, "results")
        curves_dst = os.path.join(args.reports, f"curves_torch_{tag}", mode)
        os.makedirs(curves_dst, exist_ok=True)
        copied = 0
        for name in sorted(os.listdir(curves_src)):
            if name.endswith(".svg"):
                shutil.copy(os.path.join(curves_src, name), curves_dst)
                copied += 1
        print(f"[{mode}] copied {copied} curves -> {curves_dst}", flush=True)

        scalars = scalars_from_tensorboard_logs(os.path.join(save_dir, "tensorboard_logs"))

        def last(tag):
            series = scalars.get(tag) or [(0, float("nan"))]
            return series[-1][1]

        summaries[mode] = {
            "final_train_loss": last("Train/Loss/total_loss"),
            "final_psnr_fine": last("Train/Metric/psnr_fine"),
            "test_psnr": last("Test/Metric/batch_PSNR"),
            "test_mse": last("Test/Metric/batch_MSE"),
            "train_psnr": last("Train/Metric/batch_PSNR"),
            "curves": copied,
        }

    plain_psnr = summaries.get("plain", {}).get("test_psnr", float("nan"))
    drift = summaries.get("fused", {}).get("test_psnr", float("nan")) - plain_psnr
    prop_delta = summaries.get("proposal", {}).get("test_psnr", float("nan")) - plain_psnr

    h, w = args.size * 3 // 4, args.size
    if args.scene == "room":
        n_train = (args.room_frames + args.room_stride - 1) // args.room_stride
        scene_desc = (
            f"Reference-scale room walkthrough at {w}x{h} ({n_train} train /"
            f" {n_train} test\nviews, every-{args.room_stride}th/+2 split —"
            " the reference's Replica training regime,\nreplica_dataset.py"
            ":42-43)"
        )
    else:
        scene_desc = f"Synthetic {w}x{h} orbit scene (12 train / 3 test views)"
    model_desc = (
        f"the config `{args.config}`" if args.config else
        "shipped office\nmodel config (8x256, 64+128 samples, 1024 rays/step, Adam 5e-4\n"
        "with x0.1/50k decay)"
    )
    out_md = os.path.join(args.reports, f"long_horizon_torch_{tag}.md")
    with open(out_md, "w") as f:
        f.write(
            f"# Long-horizon training study of the PyTorch port ({args.steps} steps)\n\n"
            f"{scene_desc}, {model_desc}. Trained by the port's CLI on {card},\n"
            "`--steps-per-call 100`. Modes: plain = `--field plain` (fp32; the JAX\n"
            "study's `xla`), fused = `--field fused` (the K4/K5 kernels, bf16 products;\n"
            "JAX's `pallas`), proposal = `--proposal` (JAX's `proposal`). Reference\n"
            "context: the reference trains 200k steps and reaches 23-39 dB on real\n"
            f"Replica scenes (BASELINE.md). Curves: reports/curves_torch_{tag}/<mode>/ —\n"
            "the nine charts the reference publishes under nerf/results/office_*/.\n\n"
            "| mode | final train loss | train psnr_fine | test batch PSNR "
            "| test batch MSE | train batch PSNR |\n|---|---|---|---|---|---|\n"
        )
        for mode, s in summaries.items():
            f.write(
                f"| {mode} | {s['final_train_loss']:.5f} "
                f"| {s['final_psnr_fine']:.2f} | {s['test_psnr']:.2f} "
                f"| {s['test_mse']:.2e} | {s['train_psnr']:.2f} |\n"
            )
        if {"plain", "fused"} <= set(summaries):
            f.write(
                f"\nbf16-gradient drift (fused - plain test PSNR): "
                f"{drift:+.2f} dB (|gate| {args.max_bf16_drift_db})\n"
            )
        if {"plain", "proposal"} <= set(summaries):
            f.write(f"proposal - plain test PSNR: {prop_delta:+.2f} dB\n")
    print(f"summary -> {out_md}", flush=True)
    for mode, s in summaries.items():
        print(f"[{mode}] test PSNR {s['test_psnr']:.2f} dB, "
              f"train loss {s['final_train_loss']:.5f}")
    print(f"bf16 drift {drift:+.2f} dB, proposal delta {prop_delta:+.2f} dB")
    if {"plain", "fused"} <= set(summaries) and abs(drift) > args.max_bf16_drift_db:
        print("LONG-HORIZON GATE FAILED: fused-field bf16 drift exceeds gate")
        return 1
    print("LONG-HORIZON OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
