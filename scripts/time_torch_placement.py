#!/usr/bin/env python3
"""Time builds of the placement kernel (K2 merged, K6 importance-only) against each other, on a CUDA card.

Builds `nerf_workspaces_explorer_tpu_torch/csrc/importance_merge.cu` (label
"repo") and every source given with `--against LABEL=PATH`, each with the
flags of `ops/_build.py`, into `build/torch_kernels/placement_timing/`, all
nvcc processes started together, and loads each with ctypes: every version
of the source exports `importance_merge_launch` with the same arguments. One
Python launch path (the checks and `torch.empty` of `ops/importance_merge.py`)
serves them all, so the builds differ only in their kernels. Run from the
repository root:

    python3 scripts/time_torch_placement.py --against parent=build/parent/importance_merge.cu

At the served shapes (K2 at the main path's 76,800 rays and at a 40-row
strip's 12,800; K6 at the turbo lattice's 4,800 rays and at the fast
preset's 76,800) it times each build in rounds whose order alternates
(A B ... then ... B A), three ways:

- events: one CUDA-events reading of 20 launches (`chip_smoke.py`'s `ms`);
- median: the median of 5 such readings;
- graph: 20 launches captured as one CUDA graph and replayed, the device
  alone.

Beside them the launch floor, an empty kernel through the repo build's
binding, read the same three ways. Inputs are made from a seed: sorted
random depths in [0.1, 6], Gaussian bumps of weight with every 97th ray
all-zero (the shapes of a coarse pass's output). Each build's output is
checked against the plain PyTorch version (finite, ascending, within one
coarse bin). Prints the card's name and power limit, one line per shape and
build with every reading, and one JSON line with the medians.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "torch_kernels", "placement_timing")
REPS = 20  # launches a reading
# name -> (S coarse samples, I importance samples, rays, merge)
SHAPES = {
    "K2 main path": (64, 128, 76_800, True),
    "K2 strip": (64, 128, 12_800, True),
    "K6 turbo": (64, 48, 4_800, False),
    "K6 fast": (64, 128, 76_800, False),
}


def build(sources: dict) -> dict:
    """{label: loaded library}, every source compiled by one nvcc process,
    all started together."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        lib = os.path.join(OUT_DIR, f"importance_merge_{label}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs[label] = ctypes.CDLL(lib)
    return libs


def launcher(lib, w, z, n_imp: int, merge: bool):
    """A call of `lib`'s kernel through the wrapper's launch path."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    fn = _build.entry(lib, "importance_merge_launch")
    s, r = z.shape

    def call():
        if not 3 <= s <= 256 or not (w.is_contiguous() and z.is_contiguous()):
            raise ValueError("bad inputs")
        out = torch.empty((s + n_imp if merge else n_imp, r), dtype=torch.float32, device=z.device)
        code = fn(w.data_ptr(), z.data_ptr(), out.data_ptr(), r, s, n_imp, int(merge), _build.stream_handle(z.device))
        _build.check(code, "importance_merge_launch")
        return out

    return call


def events_ms(fn, reps: int = REPS) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def readings(fn) -> dict:
    return dict(events=events_ms(fn), median=float(np.median([events_ms(fn) for _ in range(5)])), graph=graph_ms(fn))


def inputs(s: int, r: int, device, seed: int):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.random((s, r), dtype=np.float32) * 5.9 + 0.1, axis=0)
    centre = rng.random((1, r), dtype=np.float32) * 4 + 1
    w = np.exp(-0.5 * ((z - centre) / 0.4) ** 2).astype(np.float32) + 1e-4
    w[:, ::97] = 0.0
    return torch.from_numpy(w).to(device), torch.from_numpy(z).to(device)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", action="append", default=[], metavar="LABEL=PATH",
                        help="another version of importance_merge.cu to time beside the repo's")
    parser.add_argument("--rounds", type=int, default=2, help="rounds of A B ... B A")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_placement: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im

    sources = {"repo": os.path.join(ROOT, "nerf_workspaces_explorer_tpu_torch", "csrc", "importance_merge.cu")}
    for item in args.against:
        label, _, path = item.partition("=")
        sources[label] = os.path.abspath(path)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda")
    libs = build(sources)
    order = list(libs)
    order = order + order[::-1]
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    floor_lib = _build.entry(libs["repo"], "importance_empty_launch")

    def floor():
        _build.check(floor_lib(_build.stream_handle(device)), "importance_empty_launch")

    summary = {"card": card, "reps": REPS, "shapes": {}}
    for name, (s, n_imp, r, merge) in SHAPES.items():
        w, z = inputs(s, r, device, args.seed)
        ref = im.importance_merge_plain(w, z, n_imp, merge=merge)
        bin_w = float(torch.diff(z, dim=0).max())
        calls = {label: launcher(lib, w, z, n_imp, merge) for label, lib in libs.items()}
        for label, call in calls.items():
            out = call()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not (torch.isfinite(out).all() and (torch.diff(out, dim=0) >= 0).all() and err <= bin_w + 1e-4):
                raise RuntimeError(f"{name}, {label}: output off the plain version (max |err| {err:.3e})")
        got = {label: [] for label in [*calls, "floor"]}
        for _ in range(args.rounds):
            for label in order:
                got[label].append(readings(calls[label]))
            got["floor"].append(readings(floor))
        rows = {}
        for label, reads in got.items():
            rows[label] = {k: float(np.median([x[k] for x in reads])) for k in ("events", "median", "graph")}
            text = "; ".join(f"{k} " + ", ".join(f"{x[k]:.5f}" for x in reads) for k in ("events", "median", "graph"))
            print(f"{name} (S={s}, I={n_imp}, R={r}) {label}: {text}", flush=True)
        summary["shapes"][name] = rows
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
