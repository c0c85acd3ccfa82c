"""The Workspaces Explorer on the port: `python -m nerf_workspaces_explorer_tpu_torch`.

Counterpart of the repository's `main.py` (reference main.py:1-11:
QApplication + LandingPage), with its flags and defaults, plus `--device`.
The GUI is PyQt5's when installed, else tkinter's; `--backend` forces one.
Frames render on `cuda` (the hand-written render kernels of
`csrc/fused_render.cu` and `csrc/importance_merge.cu` at every precision
but parity) unless given `--device cpu`, where each kernel runs its plain
PyTorch version.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--backend", choices=("auto", "qt", "tk"), default="auto",
        help="GUI toolkit (auto: PyQt5 if installed, else tkinter)",
    )
    parser.add_argument(
        "--precision", choices=("parity", "fast", "int8", "int8-trunk"), default="fast",
        help="render precision: parity (fp32 PyTorch, the reference's arithmetic), fast (the bf16 "
        "render kernels), int8-trunk (int8 trunk products, bf16 heads) or int8 (int8 products)",
    )
    parser.add_argument(
        "--preset", choices=("reference", "fast", "turbo"), default="reference",
        help="fine-pass sample placement: reference (merged 64+128 samples, the reference "
        "renderer's), fast (importance-only fine pass, about half the fine samples), or turbo "
        "(the distilled student of the checkpoint's .turbo.npz sidecar: python -m "
        "nerf_workspaces_explorer_tpu_torch.cli.distill)",
    )
    parser.add_argument(
        "--random-init", action="store_true",
        help="run with random weights when no checkpoints exist (demo mode)",
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from nerf_workspaces_explorer_tpu_torch.app.workspace import make_workspaces

    workspaces = make_workspaces(precision=args.precision, preset=args.preset, device=args.device)
    if args.random_init:
        for workspace in workspaces:
            original = workspace.initialize_models
            workspace.initialize_models = (  # type: ignore[method-assign]
                lambda o=original: o(allow_random_init=True)
            )

    backend = args.backend
    if backend == "auto":
        try:
            import PyQt5  # noqa: F401

            backend = "qt"
        except ImportError:
            backend = "tk"

    if backend == "qt":
        from nerf_workspaces_explorer_tpu_torch.app import gui_qt

        gui_qt.run(workspaces)
    else:
        from nerf_workspaces_explorer_tpu_torch.app import gui_tk

        gui_tk.run(workspaces)


if __name__ == "__main__":
    main()
