#!/usr/bin/env python3
"""Collect a finished long training run of the PyTorch port into checked-in
artifacts (the port of `scripts/collect_long_run_report.py`).

For single runs at the reference's own schedule (200k steps, the
n_iterations of configs/office_*_config.yaml):

  python -m nerf_workspaces_explorer_tpu_torch.cli.train --office tokyo \\
      --synthetic --synthetic-size 128 --synthetic-views 12 3 \\
      --proposal --steps-per-call 100 --save-dir /tmp/run200k/proposal \\
      --save-final
  python3 scripts/collect_long_run_report_torch.py /tmp/run200k/proposal \\
      --label torch-proposal-200k

copies the nine exported SVG curves (obs/export.py, the reference's
published-results layout) into reports/curves_<label>/ and writes a
final-metrics table to reports/long_horizon_<label>.md. The scalars are the
run's history as `obs/export.py::scalars_from_tensorboard_logs` reads it:
TensorBoard event files, or the port's scalar sink (`obs/tb.py`) where the
run had no `tensorboard` package.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, REPO)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("save_dir", type=str, help="the run's --save-dir")
    parser.add_argument("--label", type=str, required=True)
    parser.add_argument("--reports", type=str, default=os.path.join(REPO, "reports"))
    parser.add_argument(
        "--notes", type=str, default="",
        help="one-line run description for the report header",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from nerf_workspaces_explorer_tpu_torch.obs.export import scalars_from_tensorboard_logs

    curves_src = os.path.join(args.save_dir, "results")
    curves_dst = os.path.join(args.reports, f"curves_{args.label}")
    os.makedirs(curves_dst, exist_ok=True)
    copied = 0
    for name in sorted(os.listdir(curves_src)):
        if name.endswith(".svg"):
            shutil.copy(os.path.join(curves_src, name), curves_dst)
            copied += 1
    print(f"copied {copied} curves -> {curves_dst}")

    scalars = scalars_from_tensorboard_logs(os.path.join(args.save_dir, "tensorboard_logs"))

    def series(tag):
        return scalars.get(tag) or []

    def last(tag):
        s = series(tag)
        return s[-1][1] if s else float("nan")

    test_psnr = series("Test/Metric/batch_PSNR")
    out_md = os.path.join(args.reports, f"long_horizon_{args.label}.md")
    with open(out_md, "w") as f:
        f.write(f"# Long-horizon run: {args.label}\n\n")
        if args.notes:
            f.write(args.notes + "\n\n")
        f.write(
            f"Curves: `reports/curves_{args.label}/` ({copied} SVGs, the "
            "reference's nine published charts).\n\n"
            "| metric | final value |\n|---|---|\n"
            f"| train total loss | {last('Train/Loss/total_loss'):.5f} |\n"
            f"| train psnr_fine | {last('Train/Metric/psnr_fine'):.2f} |\n"
            f"| train batch PSNR | {last('Train/Metric/batch_PSNR'):.2f} |\n"
            f"| test batch PSNR | {last('Test/Metric/batch_PSNR'):.2f} |\n"
            f"| test batch MSE | {last('Test/Metric/batch_MSE'):.2e} |\n\n"
        )
        if test_psnr:
            f.write("Test batch PSNR trajectory (step, dB):\n\n```\n")
            for step, val in test_psnr:
                f.write(f"{step:>8d}  {val:.2f}\n")
            f.write("```\n")
    print(f"report -> {out_md}")
    for tag in ("Train/Loss/total_loss", "Train/Metric/psnr_fine", "Test/Metric/batch_PSNR"):
        print(f"  {tag}: {last(tag):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
