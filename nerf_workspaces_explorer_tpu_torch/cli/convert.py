"""Checkpoint conversion CLI: the reference's torch `.ckpt` <-> native `.npz`.

Counterpart of `nerf_workspaces_explorer_tpu/cli/convert.py`; the two
packages read and write the same files. Usage:

    python -m nerf_workspaces_explorer_tpu_torch.cli.convert model.ckpt model.npz
    python -m nerf_workspaces_explorer_tpu_torch.cli.convert model.npz model.ckpt
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("src", help="input checkpoint (.ckpt torch or .npz native)")
    parser.add_argument("dst", help="output checkpoint (.npz native or .ckpt torch)")
    args = parser.parse_args(argv)

    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import (
        load_checkpoint,
        load_torch_checkpoint,
        save_checkpoint,
        save_torch_checkpoint,
    )

    if args.src.endswith(".ckpt") and args.dst.endswith(".npz"):
        coarse, fine, step = load_torch_checkpoint(args.src)
        save_checkpoint(args.dst, {"coarse": coarse, "fine": fine}, step=step)
    elif args.src.endswith(".npz") and args.dst.endswith(".ckpt"):
        params, step, _ = load_checkpoint(args.src)
        save_torch_checkpoint(args.dst, params["coarse"], params["fine"], step=step)
    else:
        raise SystemExit("expected .ckpt->.npz or .npz->.ckpt")
    print(f"Converted {args.src} -> {args.dst} (step {step})")


if __name__ == "__main__":
    main()
