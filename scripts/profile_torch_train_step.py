#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on a CUDA card.

Trains on the room scene at 320x240 with the stock config (8x256 nets, 1024
rays of 64 + 128 samples, the fused K4/K5 field), the setup of
`chip_smoke.py`'s training phase, times warm steps, then profiles as many
under `torch.profiler`. Prints per step the wall time (unprofiled and
profiled), the device time summed over kernels, the device idle share (1 -
device time / profiled wall time), the device time of the port's kernels
and of everything else, the device time by kernel name, and on the host the
number of aten calls and their self CPU time. With `--steps-per-call K`
the steps run K at a time as replays of a CUDA graph (`Trainer.step_many`),
and every figure is per step of those calls. `--proposal` trains the 2x64
proposal net in the coarse net's place (the interlevel loss; K4 and K5 run
through both field libraries, whose kernels share their names and are
summed), `--fast-preset` the fine net on importance-only placement (128
fine samples). Run from the repository root:

    python3 scripts/profile_torch_train_step.py [--steps-per-call 10] [--proposal] [--fast-preset]
"""

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 5  # calls before the profile: kernel build, first launches, allocator, graph capture
STEPS = 5  # profiled warm calls, averaged
PORT_KERNELS = {  # CUDA kernel name -> the port's kernel it belongs to
    "field_fwd_kernel": "K4", "field_bwd_chain_kernel": "K5", "field_dw_kernel": "K5",
    "sum_rows_kernel": "K5",
}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _port_kernel(key: str):
    """"void field_dw_kernel(DwJobs, ...)" -> "K5"; None for other kernels."""
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import kernel_name

    return PORT_KERNELS.get(kernel_name(key))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps-per-call", type=int, default=1, metavar="K")
    parser.add_argument("--proposal", action="store_true", help="the proposal net in the coarse net's place")
    parser.add_argument("--fast-preset", action="store_true", help="importance-only placement for the fine net")
    args = parser.parse_args()
    k = args.steps_per_call
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import TRAIN_FRAMES, TRAIN_SIZE, TRAIN_STRIDE, train_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_room_scene_splits
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = torch.device("cuda")
    cfg = train_config()
    near, far = cfg.rendering.depth_range
    w, h = TRAIN_SIZE
    train, test, _ = make_room_scene_splits(n_frames=TRAIN_FRAMES, stride=TRAIN_STRIDE, height=h,
                                            width=w, near=near, far=far, device=device)
    trainer = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=device,
                      save_dir=os.path.join(ROOT, "build", "torch_kernels", "profile_train"),
                      enable_tensorboard=False, steps_per_call=k, use_proposal=args.proposal,
                      merge_coarse=not args.fast_preset)
    trainer.setup()

    def call(j):  # call j: steps j k .. j k + k - 1
        if k == 1:
            trainer.step(j)
        else:
            trainer.step_many(j * k)

    for j in range(WARM):
        call(j)
    torch.cuda.synchronize()

    steps = STEPS * k
    t0 = time.perf_counter()
    for j in range(WARM, WARM + STEPS):
        call(j)
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / steps

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for j in range(WARM + STEPS, WARM + 2 * STEPS):
            call(j)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Device-side spans of `record_function` ranges (the optimizer's step)
    # cover kernels listed on their own: left out, so nothing counts twice.
    kernels = [
        e for e in prof.key_averages()
        if _device_us(e) > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    by_port = {"K4": 0.0, "K5": 0.0, "other": 0.0}
    for e in kernels:
        by_port[_port_kernel(e.key) or "other"] += _device_us(e) / 1e3 / steps
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")]
    print(f"card: {card}")
    mode = "eager" if k == 1 else f"CUDA-graph replays of {k} steps"
    nets = ("proposal 2x64 + fine 8x256" if args.proposal else "coarse + fine 8x256") + (
        ", importance-only placement" if args.fast_preset else "")
    print(f"train step ({nets}, {trainer.field_impl} field, {mode}): wall {bare_ms:.2f} ms unprofiled; profiled wall "
          f"{wall_ms:.2f} ms, device {device_ms:.2f} ms, device idle share {1.0 - device_ms / wall_ms:.3f} "
          f"(per step, over {steps} steps each)")
    print("  " + ", ".join(f"{k} {v:.3f} ms/step" for k, v in by_port.items()))
    if not kernels:
        print("no device time captured by the profiler")
    for e in sorted(kernels, key=_device_us, reverse=True)[:20]:
        print(f"  {_device_us(e) / 1e3 / steps:9.3f} ms/step  x{e.count // steps:<4d} {e.key[:90]}")
    print(f"host: {sum(e.count for e in host) / steps:.0f} aten calls per step, self CPU "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3 / steps:.2f} ms/step (profiled)")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]:
        print(f"  {e.self_cpu_time_total / 1e3 / steps:9.3f} ms/step  x{e.count // steps:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
