"""Cells that serve frames: a closed loop of one client, each request
answered with a uint8 frame on the host.

The generator named by the mix's `kind` builds the program's system from
the configuration, makes the requests from the seed and serves one; this
module times the window, traces part of it on request, and judges the
frames it served against the plain reference (`reference/nerf.py`).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from harness import runtime
from harness import trace as trace_mod
from harness.manifest import ROOT
from reference import compare, nerf


class Window(NamedTuple):
    seed: int
    seconds: float  # host clock from the first request's start to the last answer
    requests: List[dict]  # served, in order
    latencies_s: List[float]
    frames: List[Optional[np.ndarray]]  # None where serving raised
    errors: List[str]
    traced: List[int]  # indices of the requests inside the profiled span
    trace: Optional[trace_mod.Trace]


def reference_spec(config: dict, mix: dict) -> dict:
    near, far = config["serve"]["depth_range"]
    ref = config["reference"]
    return dict(height=int(mix["height"]), width=int(mix["width"]), near=float(near), far=float(far),
                n_samples=int(ref["n_samples"]), n_importance=int(ref["n_importance"]), merge=bool(ref["merge"]),
                density_net=ref["density_net"], stride=int(ref.get("stride", 1)),
                eps=float(config["serve"]["early_stop_eps"]))


def reference_nets(config: dict, device) -> Dict[str, nerf.Net]:
    nets = config["nets"]
    return nerf.load_nets(
        f"{ROOT}/{config['reference']['weights']}", device,
        {k: tuple(v["skips"]) for k, v in nets.items()},
        {k: (v["pts_freqs"], v["view_freqs"]) for k, v in nets.items()},
    )


class FrameCell:
    """One frame cell's program side: the system built once, warmed up,
    then any number of windows."""

    def __init__(self, config: dict, mix: dict, cell: dict, gen, device, precision: Optional[str] = None,
                 serve: Optional[Callable] = None) -> None:
        self.config, self.mix, self.cell, self.gen = config, mix, cell, gen
        self.device = torch.device(device)
        self.system = gen.build(config, mix, self.device, precision or config["serve"]["precision"])
        self.serve = serve or gen.serve

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, seed: int) -> None:
        """Serve the generator's warm-up requests: every kernel this cell's
        frames launch is built and loaded, every shape launched once."""
        reqs = self.gen.requests(self.mix, seed)
        for req in self.gen.warmup(reqs, self.mix):
            self.serve(self.system, req)
        self._sync()

    def window(self, seed: int, seconds: float, trace: bool = False) -> Window:
        """Serve requests back to back, from the seed's first, until
        `seconds` have passed on the host's clock; with `trace`, profile the
        cell's `trace.units` requests from its `trace.start`-th on."""
        reqs = self.gen.requests(self.mix, seed)
        t_cfg = self.cell["trace"]
        t_lo, t_hi = (int(t_cfg["start"]), int(t_cfg["start"]) + int(t_cfg["units"])) if trace else (-1, -1)
        served, lat, frames, errors, traced = [], [], [], [], []
        prof = prof_done = None
        self._sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            req = reqs[i % len(reqs)]
            if i == t_lo:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            ts = time.perf_counter()
            try:
                if prof is not None:
                    with torch.profiler.record_function(trace_mod.UNIT_SPAN):
                        frame = self.serve(self.system, req)
                else:
                    frame = self.serve(self.system, req)
            except Exception as exc:  # a failed request is counted, and the loop goes on
                frame = None
                errors.append(f"{type(exc).__name__}: {exc}")
            te = time.perf_counter()
            served.append(req)
            lat.append(te - ts)
            frames.append(frame)
            if prof is not None:
                traced.append(i)
            i += 1
            if prof is not None and i == t_hi:
                prof.__exit__(None, None, None)
                prof_done, prof = prof, None
            if te - t0 >= seconds and i >= t_hi:
                break
        tr = trace_mod.read_profile(prof_done) if prof_done is not None else None
        return Window(seed, te - t0, served, lat, frames, errors, traced, tr)

    def free(self) -> None:
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sample_indices(win: Window, n: int) -> List[int]:
    """The slowest request and n - 1 others drawn from the seed."""
    slowest = int(np.argmax(win.latencies_s))
    rest = [i for i in range(len(win.frames)) if i != slowest]
    rng = np.random.default_rng(np.random.SeedSequence([int(win.seed), 3]))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [slowest] + sorted(rest[int(k)] for k in pick)


def sample_pixels(seed: int, index: int, n_pix: int, n: int) -> np.ndarray:
    """n of a frame's n_pix pixels (flat indices, ascending), drawn from the
    seed and the request's index in the window."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 4, int(index)]))
    return np.sort(rng.choice(n_pix, size=min(n, n_pix), replace=False))


def judge(win: Window, config: dict, mix: dict, cell: dict, gen, device,
          nets: Optional[Dict[str, nerf.Net]] = None) -> dict:
    """Hold a sample of the served frames against the reference: the
    slowest frame and `check.frames - 1` more drawn from the seed, each at
    `check.pixels` of its pixels drawn from the seed. A traced window's
    frames are rendered whole, for their sample counts. Returns {"numbers":
    `compare.sample_numbers` of the sample, "frame_means" and
    "frame_biases": each sampled frame's mean absolute and mean signed gap,
    "counts": [nerf.Frame of each traced request, without its pixels]}."""
    nets = nets or reference_nets(config, device)
    spec = reference_spec(config, mix)
    n_pix = spec["height"] * spec["width"]
    per_frame, counts = [], []
    with nerf.fp32_matmuls():
        for i in sample_indices(win, int(cell["check"]["frames"])):
            pix = sample_pixels(win.seed, i, n_pix, int(cell["check"]["pixels"]))
            ref = nerf.render_frame(nets, gen.reference_pose(win.requests[i], mix), spec, device,
                                    pixels=torch.as_tensor(pix))
            served = win.frames[i]
            ok = served is not None and served.shape == (spec["height"], spec["width"], 3)
            per_frame.append(compare.gaps(served.reshape(n_pix, 3)[pix] if ok else None, ref.rgb8.cpu().numpy()))
        for i in win.traced:
            ref = nerf.render_frame(nets, gen.reference_pose(win.requests[i], mix), spec, device)
            counts.append(ref._replace(rgb8=None))
    return dict(numbers=compare.sample_numbers(per_frame), frame_means=[float(np.abs(g).mean()) for g in per_frame],
                frame_biases=[float(g.mean()) for g in per_frame], counts=counts)


def run_cell(entry: dict, config: dict, mix: dict, cell: dict, gen, readers: Dict[str, object], *, seed: int,
             seconds: float, trace: bool, device, t_start: float, serve: Optional[Callable] = None) -> dict:
    """One run: set-up, the window, the device's reading, the check that no
    forbidden module is loaded, the program freed, the reference's check,
    the metrics. Returns the result line's fields (`checks` last)."""
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
    verdict = judge(win, config, mix, cell, gen, fc.device)
    check_s = time.perf_counter() - t_check
    checks = {name: {"value": verdict["numbers"].get(name, float("inf")), "limit": float(limit)}
              for name, limit in cell["check"]["limits"].items()}
    correct = not win.errors and all(c["value"] <= c["limit"] for c in checks.values())
    ctx = dict(window=win, setup_s=setup_s, trace=win.trace, counts=verdict["counts"], config=config, mix=mix)
    return runtime.result_line(correct, len(win.requests), len(win.errors), readers, ctx, device_line, win.trace,
                               dict(numbers=verdict["numbers"], check_s=check_s, errors=win.errors[:3]), checks)
