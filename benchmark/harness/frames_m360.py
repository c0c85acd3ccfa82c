"""Cells that serve mip-NeRF 360 frames: `harness/frames.py`'s closed loop
of one client (its `FrameCell`, the same warm-up, window, trace and
sample of frames and pixels), judged against the plain float32 mip-NeRF 360
(`reference/mipnerf360.py`) instead of the positional NeRF.

The traced frames' operation counts come from the configuration's spec
(`harness/counts_m360.py`): every sample is evaluated, so a frame's work is
its rays. `half_rays` is this path's fault for the tests: the program's
compositing leaves half of each call's rays black. Readings for the limits:

    python3 benchmark/harness/frames_m360.py --workload m360-click-320 --seeds 1,2,3 [--control] [--fault half_rays|stale_answer]

(`--control`: the reference with every product's operands rounded to
float8 e4m3 in the program's place; the program has no path below bf16 at
this width. `run_cell(..., control=True)` judges the control's frames
through the cell's limits.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_BENCH, os.path.dirname(_BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import faults, manifest, runtime  # noqa: E402
from harness.frames import FrameCell, Window, sample_indices, sample_pixels  # noqa: E402
from harness.manifest import ROOT  # noqa: E402
from reference import compare  # noqa: E402
from reference import mipnerf360 as ref  # noqa: E402


def reference_model(config: dict, device):
    """(params, spec) drawn from the reference's checkpoint's seed."""
    return ref.load(os.path.join(ROOT, config["reference"]["weights"]), device)


def judge(win: Window, config: dict, mix: dict, cell: dict, gen, device, model=None,
          frames_of: Optional[Callable] = None) -> dict:
    """As `frames.judge`: the slowest frame and `check.frames - 1` more drawn
    from the seed, `check.pixels` pixels of each, against the reference.
    `frames_of(i, pixels)` gives the answers judged (default: the window's
    frames at those pixels). "counts": the rays of each traced frame."""
    params, spec = model or reference_model(config, device)
    h, w = int(mix["height"]), int(mix["width"])
    n_pix = h * w
    per_frame = []
    with ref.fp32_matmuls():
        for i in sample_indices(win, int(cell["check"]["frames"])):
            pix = sample_pixels(win.seed, i, n_pix, int(cell["check"]["pixels"]))
            want = ref.render_frame(params, spec, gen.reference_pose(win.requests[i], mix), h, w, device,
                                    pixels=torch.as_tensor(pix)).cpu().numpy()
            if frames_of is not None:
                got = frames_of(i, pix)
            else:
                served = win.frames[i]
                ok = served is not None and served.shape == (h, w, 3)
                got = served.reshape(n_pix, 3)[pix] if ok else None
            per_frame.append(compare.gaps(got, want))
    return dict(numbers=compare.sample_numbers(per_frame), frame_means=[float(np.abs(g).mean()) for g in per_frame],
                frame_biases=[float(g.mean()) for g in per_frame], counts=[dict(rays=n_pix) for _ in win.traced])


def control_frames(win: Window, mix: dict, gen, model, device) -> Callable:
    """`judge`'s `frames_of` for the float8 control: the reference with every
    product's operands rounded to float8 e4m3, at the window's requests."""
    from reference.train import fp8_matmul

    params, spec = model

    def frames_of(i, pix):
        return ref.render_frame(params, spec, gen.reference_pose(win.requests[i], mix), int(mix["height"]),
                                int(mix["width"]), device, pixels=torch.as_tensor(pix),
                                matmul=fp8_matmul).cpu().numpy()

    return frames_of


def run_cell(entry: dict, config: dict, mix: dict, cell: dict, gen, readers: Dict[str, object], *, seed: int,
             seconds: float, trace: bool, device, t_start: float, serve: Optional[Callable] = None,
             control: bool = False) -> dict:
    """`frames.run_cell` with this module's judge; `control`: the float8
    control's frames judged in the program's place."""
    fc = FrameCell(config, mix, cell, gen, device, serve=serve)
    fc.warm(seed)
    setup_s = time.perf_counter() - t_start
    win = fc.window(seed, seconds, trace)
    device_line = runtime.device_info(int(entry["chips"]), fc.device)
    bad = runtime.forbidden_modules()
    if bad:
        raise runtime.ForbiddenModules(bad)
    fc.free()
    t_check = time.perf_counter()
    model = reference_model(config, fc.device)
    frames_of = control_frames(win, mix, gen, model, fc.device) if control else None
    verdict = judge(win, config, mix, cell, gen, fc.device, model=model, frames_of=frames_of)
    check_s = time.perf_counter() - t_check
    checks = {name: {"value": verdict["numbers"].get(name, float("inf")), "limit": float(limit)}
              for name, limit in cell["check"]["limits"].items()}
    correct = not win.errors and all(c["value"] <= c["limit"] for c in checks.values())
    ctx = dict(window=win, setup_s=setup_s, trace=win.trace, counts=verdict["counts"], config=config, mix=mix)
    return runtime.result_line(correct, len(win.requests), len(win.errors), readers, ctx, device_line, win.trace,
                               dict(numbers=verdict["numbers"], check_s=check_s, errors=win.errors[:3]), checks)


@contextlib.contextmanager
def half_rays():
    """The program's compositing leaves half of each call's rays black."""
    import nerf_workspaces_explorer_tpu_torch.ops.mipnerf360 as m3

    real = m3.composite

    def composite(*args, **kwargs):
        w, color = real(*args, **kwargs)
        if color is not None:
            color = color.clone()
            color[color.shape[0] // 2 :] = 0.0
        return w, color

    m3.composite = composite
    try:
        yield
    finally:
        m3.composite = real


FAULTS = {"half_rays": half_rays}


def readings(workload: str, seeds, seconds: float, control: bool, device="cuda", fault=None) -> list:
    """A seed's judged numbers: the program's (with `fault` planted), or the
    float8 control's over the same sample of the window's requests."""
    man = manifest.manifest()
    entry = manifest.workload_entry(man, workload)
    config = manifest.load_config(man, entry["config"])
    mix = manifest.load_traffic(entry["traffic"])
    cell = manifest.load_cell(workload)
    gen = manifest.generator(mix["kind"])
    with FAULTS[fault]() if fault in FAULTS else contextlib.nullcontext():
        serve = faults.stale_answer(gen.serve) if fault == "stale_answer" else None
        fc = FrameCell(config, mix, cell, gen, device, serve=serve)
        model = reference_model(config, fc.device)
        fc.warm(int(seeds[0]))
        out = []
        for seed in seeds:
            win = fc.window(int(seed), seconds)
            frames_of = control_frames(win, mix, gen, model, fc.device) if control else None
            verdict = judge(win, config, mix, cell, gen, fc.device, model=model, frames_of=frames_of)
            out.append(dict(seed=int(seed), precision="float8 reference" if control else "program",
                            frames=len(win.requests), errors=len(win.errors), numbers=verdict["numbers"],
                            frame_means=verdict["frame_means"], frame_biases=verdict["frame_biases"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=(*FAULTS, "stale_answer"))
    args = p.parse_args(argv)
    for r in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.control,
                      fault=args.fault):
        print(json.dumps(dict(workload=args.workload, fault=args.fault, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
