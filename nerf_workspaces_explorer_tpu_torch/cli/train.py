"""Training CLI of the port: a NeRF trained on an office's Replica sequence,
or with `--synthetic` on an analytic scene.

Counterpart of `nerf_workspaces_explorer_tpu/cli/train.py` (reference
nerf/train.py:11-56: `--office` whitelist, config load, handler setup, the
per-step wall-clock print). Without `--synthetic` the Trainer loads
`replica_dataset/<office>/Sequence_1` (`data.replica.ReplicaDataset`, at
the config's image size). Runs on `cuda` (the fused K4/K5 field kernels)
unless given `--device cpu` (plain PyTorch). `--mesh N` trains data-
parallel over the first N cards (`parallel.data_mesh`); with `--device cpu`
over N shards of the CPU, the port's stand-in for JAX's virtual devices.
`--steps-per-call K` advances the steps K a call up to each cadence
boundary: on `cuda` a replay of a CUDA graph of K steps (with `--mesh N`,
of K data-parallel steps), on the CPU K eager steps (the same trajectory
as one step a call). `--proposal` trains a
2x64 proposal net in the coarse net's place (the interlevel loss),
`--fast-preset` the fine net on importance-only placement; `--profile DIR`
traces the first 20 steps with `torch.profiler` into DIR/trace.json,
`--nan-debug` turns on autograd's anomaly detection, `--export-final`
writes final_models/<office>/model.npz and the reference's model.ckpt
(which has no slot for a proposal net: refused with `--proposal`).

Usage:
    python -m nerf_workspaces_explorer_tpu_torch.cli.train --office tokyo
    python -m nerf_workspaces_explorer_tpu_torch.cli.train --synthetic --scene room
    python -m nerf_workspaces_explorer_tpu_torch.cli.train --synthetic --scene room \\
        --steps-per-call 10
    python -m nerf_workspaces_explorer_tpu_torch.cli.train --synthetic --scene room \\
        --proposal --fast-preset
    python -m nerf_workspaces_explorer_tpu_torch.cli.train --synthetic --device cpu \\
        --synthetic-size 16 --iterations 40
    python -m nerf_workspaces_explorer_tpu_torch.cli.train --synthetic --scene room --mesh 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

AVAILABLE_OFFICES = ("tokyo", "new_york", "geneve", "belgrade")

# Steps traced by --profile (JAX cli/train.py:218-222).
PROFILE_STEPS = 20


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--office", type=str, default="tokyo")
    parser.add_argument("--config", type=str, default=None,
                        help="config YAML (reference schema) in place of the office's")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None, help="checkpoint to resume")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on a synthetic scene instead of the office's Replica sequence")
    parser.add_argument("--synthetic-size", type=int, default=64, help="image width (height 3/4 of it)")
    parser.add_argument("--synthetic-views", type=int, nargs=2, default=(8, 2),
                        metavar=("N_TRAIN", "N_TEST"), help="--scene orbit view counts")
    parser.add_argument("--scene", choices=("orbit", "room"), default="orbit",
                        help="orbit (blob orbit) or room (interior walkthrough, every-5th/+2 split)")
    parser.add_argument("--room-frames", type=int, default=900, help="--scene room: trajectory frames")
    parser.add_argument("--room-stride", type=int, default=5, help="--scene room: train ids = every Nth frame")
    parser.add_argument("--scene-cache", type=str, default=None,
                        help="--scene room: ground-truth cache directory (none by default)")
    parser.add_argument("--save-final", action="store_true",
                        help="save a checkpoint at the final step into <save-dir>/checkpoints")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save-dir", type=str, default=None)
    parser.add_argument("--field", choices=("auto", "plain", "fused"), default="auto",
                        help="training field: fused = the K4/K5 CUDA kernels (bf16 products), "
                        "plain = fp32 PyTorch, auto = fused on cuda, plain on the CPU")
    parser.add_argument("--eval-max-views", type=int, default=0, metavar="N",
                        help="evenly subsample the eval renders to at most N views (0 = all)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--steps-per-call", type=int, default=1, metavar="K",
                        help="steps per call between cadence boundaries: a CUDA-graph replay of K "
                        "steps on cuda, K eager steps on the CPU (the print cadence is raised to K)")
    parser.add_argument("--proposal", action="store_true",
                        help="replace the coarse 8x256 net with a 2x64 proposal density net trained by the "
                        "interlevel loss (changes sample placement against the reference)")
    parser.add_argument("--fast-preset", action="store_true",
                        help="train the fine net on the importance-only placement (merge_coarse=False) it "
                        "sees under the fast serving preset")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help=f"a torch.profiler trace of the first {PROFILE_STEPS} steps into DIR/trace.json")
    parser.add_argument("--nan-debug", action="store_true",
                        help="raise in backward on the first NaN (autograd anomaly detection; slow)")
    parser.add_argument("--export-final", action="store_true",
                        help="on completion, save final_models/<office>/model.npz and the reference's model.ckpt")
    parser.add_argument("--mesh", type=int, default=0, help="devices for data parallelism")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    office_name = str(args.office).lower().strip().replace(" ", "_")
    if office_name not in AVAILABLE_OFFICES:
        raise RuntimeError(f"Office {office_name} not available for training.")
    office = f"office_{office_name}"
    if args.export_final and args.proposal:
        # The JAX CLI finds out after training, in a KeyError (cli/train.py:266).
        raise ValueError("--export-final writes the reference's model.ckpt, which holds a coarse and a fine "
                         "net and has no slot for --proposal's proposal net")

    import torch

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import (
        make_room_scene_splits,
        make_synthetic_scene,
    )
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import save_checkpoint, save_torch_checkpoint
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import resolve_device
    from nerf_workspaces_explorer_tpu_torch.obs.debug import enable_nan_debugging
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import trace_context
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    if args.nan_debug:
        enable_nan_debugging()
    device = resolve_device(torch.device(args.device))
    mesh = None
    if args.mesh > 0:
        mesh = data_mesh(args.mesh, devices=[device] * args.mesh if device.type == "cpu" else None)
        device = mesh.devices[0]
    config = load_config(args.config, office_name=office)
    if args.steps_per_call > 1 and 0 < config.logging.step_log_print < args.steps_per_call:
        # A print every step would make every step a cadence boundary and
        # leave no K-step stretch: stretch the print cadence to K.
        config = dataclasses.replace(
            config, logging=dataclasses.replace(config.logging, step_log_print=args.steps_per_call)
        )
        print(f"(--steps-per-call {args.steps_per_call}: console print cadence raised to every "
              f"{args.steps_per_call} steps)")
    train_data = test_data = None  # without --synthetic the Trainer loads the Replica sequence
    size = args.synthetic_size
    if args.synthetic and args.scene == "room":
        near, far = 0.1, 8.0
        config = dataclasses.replace(
            config, rendering=dataclasses.replace(config.rendering, depth_range=(near, far))
        )
        train_data, test_data, _ = make_room_scene_splits(
            n_frames=args.room_frames, stride=args.room_stride, height=size * 3 // 4, width=size,
            seed=7 + args.seed, near=near, far=far, cache_dir=args.scene_cache, device=device,
        )
        print(f"room scene: {len(train_data)} train / {len(test_data)} test views at "
              f"{size}x{size * 3 // 4}")
    elif args.synthetic:
        near, far = config.rendering.depth_range
        n_train, n_test = args.synthetic_views
        train_data, test_data, _ = make_synthetic_scene(
            n_train=n_train, n_test=n_test, height=size * 3 // 4, width=size, seed=args.seed,
            near=near, far=far, device=device,
        )

    trainer = Trainer(
        office, config, train_data=train_data, test_data=test_data, seed=args.seed,
        save_dir=args.save_dir, field_impl=args.field, use_proposal=args.proposal,
        merge_coarse=not args.fast_preset, steps_per_call=args.steps_per_call,
        eval_max_views=args.eval_max_views, device=device, mesh=mesh,
    )
    trainer.setup()
    start_step = 0
    if args.resume is not None:
        start_step = trainer.resume_from_checkpoint(args.resume)
        print(f"Resumed from {args.resume} at step {start_step}")
    num_iterations = args.iterations if args.iterations is not None else config.training.n_iterations

    print("#" * 80)
    print("------------------------------- Training loop ---------------------------------")
    print("#" * 80)
    main_start = start_step
    if args.profile:
        # The first steps under the profiler, one step a call (JAX
        # cli/train.py:218-222).
        main_start = min(start_step + PROFILE_STEPS, num_iterations)
        with trace_context(args.profile):
            for i in range(start_step, main_start):
                trainer.step(i)
        print(f"Profiled steps {start_step + 1}..{main_start} into {os.path.join(args.profile, 'trace.json')}")
    if args.steps_per_call > 1:
        # K-step calls; per-step wall-clock prints only make sense one step
        # at a time, so fit() owns the loop (JAX cli/train.py:223-236).
        loop_start = time.time()
        trainer.fit(num_iterations, start_step=main_start)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        duration = time.time() - loop_start
        done = num_iterations - main_start
        if done > 0:
            print(f"Finished steps {main_start + 1}..{num_iterations} in {duration:.1f} sec "
                  f"({done / duration:.1f} steps/s, {args.steps_per_call} steps/dispatch)")
    else:
        for i in range(main_start, num_iterations):
            step_start = time.time()
            trainer.step(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            duration = time.time() - step_start
            print(f"Finished step: {i + 1}/{num_iterations} --> Step duration: {duration} sec")

    if args.save_final:
        trainer.save_models_checkpoint(num_iterations)
    written = trainer.export_results()
    if written:
        print(f"Exported {len(written)} result curves to {trainer.save_dir}/results")
    if args.export_final:
        # Relative to the working directory, as the JAX CLI writes them.
        final_dir = os.path.join("final_models", office)
        step = int(trainer.state.step)
        save_checkpoint(os.path.join(final_dir, "model.npz"), trainer.params, step=step,
                        metadata={"office": office})
        save_torch_checkpoint(os.path.join(final_dir, "model.ckpt"), trainer.params["coarse"],
                              trainer.params["fine"], step=step)
        print(f"Exported the final model to {final_dir}/model.npz and the reference-format {final_dir}/model.ckpt")


if __name__ == "__main__":
    main()
