#!/usr/bin/env python3
"""Time builds of the int4 probe kernel (K9) against each other, on a CUDA card.

Builds `nerf_workspaces_explorer_tpu_torch/csrc/int4_probe.cu` (label "repo")
and every source given with `--against LABEL=PATH`, each with the flags of
`ops/_build.py` (and the include path of its own directory, for a source
that includes headers beside it), into `build/torch_kernels/int4_timing/`,
all nvcc processes started together, and loads each with ctypes: every
version of the source exports `int4_probe_launch` with the same arguments.
One Python launch path (the checks and `torch.empty` of `ops/int4_probe.py`)
serves them all, so the builds differ only in their kernels. Run from the
repository root:

    python3 scripts/time_torch_int4.py --against parent=build/parent/csrc/int4_probe.cu

For both legs of the probe (int4 [128, 128] one value a byte, and packed
two a byte, times bf16 [128, 128]; `scripts/probe_int4_torch.py`'s inputs)
it times each build in rounds whose order alternates (A B ... then ... B A),
three ways, as `scripts/time_torch_placement.py` does:

- events: one CUDA-events reading of 50 launches (`chip_smoke.py`'s `ms`);
- median: the median of 5 such readings;
- graph: 50 launches captured as one CUDA graph and replayed, the device
  alone.

Beside them the launch floor, an empty kernel through the placement
library's ctypes binding (`ops/importance_merge.py::empty_launch`), read the
same three ways. Each build's output is checked against the plain version
(relative error <= 1e-6: exact products, fp32 sums in another order).
Prints the card's name and power limit, one line per leg and build with
every reading, and one JSON line with the medians.
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
OUT_DIR = os.path.join(ROOT, "build", "torch_kernels", "int4_timing")
REPS = 50  # launches a reading, as chip_smoke.py's K9 `ms`
LEGS = {"int4-operand": False, "int4x2-packed-bytes": True}


def build(sources: dict) -> dict:
    """{label: loaded library}, every source compiled by one nvcc process,
    all started together."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        lib = os.path.join(OUT_DIR, f"int4_probe_{label}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", os.path.dirname(src), "-o", lib, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs[label] = ctypes.CDLL(lib)
    return libs


def launcher(lib, a, b, packed: bool):
    """A call of `lib`'s kernel through the wrapper's launch path."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    fn = _build.entry(lib, "int4_probe_launch")
    m, (k, n) = a.shape[0] * (2 if packed else 1), b.shape

    def call():
        if m % 64 or n % 128 or k != 128 or not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("bad inputs")
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(packed), _build.stream_handle(b.device))
        _build.check(code, "int4_probe_launch")
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", action="append", default=[], metavar="LABEL=PATH",
                        help="another version of int4_probe.cu to time beside the repo's")
    parser.add_argument("--rounds", type=int, default=2, help="rounds of A B ... B A")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_int4: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from probe_int4_torch import leg_inputs

    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.ops import int4_probe as ip

    sources = {"repo": os.path.join(ROOT, "nerf_workspaces_explorer_tpu_torch", "csrc", "int4_probe.cu")}
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

    def floor():
        im.empty_launch(device)

    summary = {"card": card, "reps": REPS, "legs": {}}
    np.random.seed(args.seed)
    for leg, packed in LEGS.items():
        a, b, _ = leg_inputs(packed, device)
        ref = ip.int4_matmul_plain(a, b, packed=packed)
        calls = {label: launcher(lib, a, b, packed) for label, lib in libs.items()}
        for label, call in calls.items():
            out = call()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            if not (torch.isfinite(out).all() and err <= 1e-6):
                raise RuntimeError(f"{leg}, {label}: output off the plain version (rel err {err:.3e})")
        got = {label: [] for label in [*calls, "floor"]}
        for _ in range(args.rounds):
            for label in order:
                got[label].append(readings(calls[label]))
            got["floor"].append(readings(floor))
        rows = {}
        for label, reads in got.items():
            rows[label] = {k: float(np.median([x[k] for x in reads])) for k in ("events", "median", "graph")}
            text = "; ".join(f"{k} " + ", ".join(f"{x[k]:.5f}" for x in reads) for k in ("events", "median", "graph"))
            print(f"K9 {leg} {label}: {text}", flush=True)
        summary["legs"][leg] = rows
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
