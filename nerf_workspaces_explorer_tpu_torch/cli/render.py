"""Headless rendering CLI: views of a workspace from a trained checkpoint.

Counterpart of `nerf_workspaces_explorer_tpu/cli/render.py`: the GUI's render
path without a display, one view from floor-plan relative coordinates or a
camera tour streamed through `render_poses_uint8_stream`, written as PNGs
(`utils.png`; the JAX CLI's tour mp4 needs imageio, which the port does not
use). Runs on the CUDA card unless given `--device cpu`.

Usage:
    # one view from floor-plan relative coordinates:
    python -m nerf_workspaces_explorer_tpu_torch.cli.render --office tokyo \\
        --ckpt model.npz --rel-x 0.5 --rel-y 0.5 --hangle 30 --out out/

    # a left-right + up-down camera tour:
    python -m nerf_workspaces_explorer_tpu_torch.cli.render --office tokyo \\
        --ckpt model.npz --tour --out out/
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--office", type=str, default="tokyo")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--rel-x", type=float, default=0.5)
    parser.add_argument("--rel-y", type=float, default=0.5)
    parser.add_argument("--hangle", type=int, default=0)
    parser.add_argument("--vangle", type=int, default=0)
    parser.add_argument("--tour", action="store_true", help="render a camera tour")
    parser.add_argument("--tour-step", type=int, default=30, help="angle step (deg)")
    parser.add_argument("--out", type=str, default="renders")
    parser.add_argument("--precision", type=str, default="parity", choices=("parity", "fast", "int8", "int8-trunk"))
    parser.add_argument(
        "--preset", type=str, default="reference", choices=("reference", "fast", "turbo"),
        help="fine-pass placement: reference (merged 64+128), fast (importance-only fine pass), or turbo "
        "(the distilled student of the checkpoint's .turbo.npz sidecar)",
    )
    parser.add_argument("--random-init", action="store_true",
                        help="render from random weights when no checkpoint exists (smoke tests)")
    parser.add_argument("--width", type=int, default=None, help="override render width")
    parser.add_argument("--height", type=int, default=None, help="override render height")
    parser.add_argument("--coarse-only", action="store_true",
                        help="render with the coarse net only (n_importance=0), through the fp32 pipeline")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    office = f"office_{str(args.office).lower().strip().replace(' ', '_')}"
    if args.coarse_only and args.precision != "parity":
        parser.error("--coarse-only renders through the fp32 pipeline; the fused path is coarse + fine: "
                     "use --precision parity")

    from nerf_workspaces_explorer_tpu_torch.app.workspace import WORKSPACE_CLASSES
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.utils.png import write_png

    if office not in WORKSPACE_CLASSES:
        raise RuntimeError(f"Office {office} unknown.")

    renderer = None
    if args.width or args.height or args.coarse_only:
        cfg = load_config(office_name=office)
        experiment = dataclasses.replace(
            cfg.experiment,
            image_width=args.width or cfg.experiment.image_width,
            image_height=args.height or cfg.experiment.image_height,
        )
        rendering = dataclasses.replace(cfg.rendering, n_importance=0) if args.coarse_only else cfg.rendering
        # The fp32 pipeline pads a frame to whole chunks: no chunk beyond the frame.
        n_pix = experiment.image_width * experiment.image_height
        inference = dataclasses.replace(cfg.inference, chunk=min(cfg.inference.chunk, n_pix))
        cfg = dataclasses.replace(cfg, experiment=experiment, rendering=rendering, inference=inference)
        renderer = NeRFRenderer(office, args.ckpt, config=cfg, precision=args.precision, preset=args.preset,
                                device=args.device)

    workspace = WORKSPACE_CLASSES[office](
        ckpt_path=args.ckpt, precision=args.precision, preset=args.preset, renderer=renderer, device=args.device,
    )
    workspace.initialize_models(allow_random_init=args.random_init)

    os.makedirs(args.out, exist_ok=True)
    if not args.tour:
        start = time.perf_counter()
        image = workspace.render_image(args.rel_x, args.rel_y, args.hangle, args.vangle)
        elapsed = time.perf_counter() - start
        path = os.path.join(args.out, f"{office}_x{args.rel_x}_y{args.rel_y}_h{args.hangle}_v{args.vangle}.png")
        write_png(path, image)
        print(f"Rendered {path} in {elapsed:.2f}s")
        return

    # Tour: sweep horizontal angles then vertical angles (the GUI's four
    # camera buttons, reference application/app.py:384-414, step 30 deg),
    # streamed: later frames are enqueued on the device before a frame is
    # copied to the host.
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates

    angles = list(range(-90, 91, args.tour_step))
    views = [(h, 0) for h in angles] + [(0, v) for v in angles]
    init, _ = workspace.transform_relative_coordinates(args.rel_x, args.rel_y, 0, 0)
    deltas = [workspace.transform_relative_coordinates(args.rel_x, args.rel_y, h, v)[1] for h, v in views]
    poses = poses_from_coordinates(init, deltas)
    start = time.perf_counter()
    frames = list(workspace.renderer.render_poses_uint8_stream(poses, lookahead=3))
    elapsed = time.perf_counter() - start
    for i, frame in enumerate(frames):
        write_png(os.path.join(args.out, f"{office}_tour_{i:03d}.png"), frame)
    print(f"Rendered {len(frames)}-frame tour in {elapsed:.2f}s ({elapsed / len(frames):.2f}s/frame) -> {args.out}")


if __name__ == "__main__":
    main()
