#!/usr/bin/env python3
"""Time builds of the training field's backward (K5) against each other, on a CUDA card.

Builds `nerf_workspaces_explorer_tpu_torch/csrc/train_field.cu` (label
"repo") and every source given with `--against LABEL=PATH`, once per network
shape of `CASES`, each with the flags of `ops/_build.py` and the shape's
`-DFIELD_*` flags (and the include path of the source's own directory, for
its headers), into `build/torch_kernels/field_timing/`, all nvcc processes
started together, and loads each with ctypes: every version of the source
exports `field_backward_launch` and `field_backward_sizes` with the same
arguments. One Python launch path (`ops/fused_field.py`'s packed weight
stream, slab tables and buffers) serves them all, so the builds differ only
in their kernels. Run from the repository root:

    python3 scripts/time_torch_field.py --against parent=build/parent/csrc/train_field.cu

At the training step's shapes (the stock 8x256 net's coarse and fine calls,
65,536 and 196,608 points; the 2x64@6f/2f proposal net at 65,536; the
6x192@10f and 4x128@8f students at a distillation step's 196,608) it times
each build in rounds whose order alternates (A B ... then ... B A):

- k5: one CUDA-events reading of REPS calls (the four kernels of a K5
  call), ms a call;
- chain, dw, sums: each kernel's device time a call, from a
  `torch.profiler` trace of REPS calls.

Inputs are made from a seed (a seeded initialisation of the net, Gaussian
points, unit view directions, cotangents of 1e-3). Each build's dW and db
are compared bit for bit with the first label's. Prints the card's name and
power limit, one line per case and build with every reading, and one JSON
line with the medians.
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
OUT_DIR = os.path.join(ROOT, "build", "torch_kernels", "field_timing")
REPS = 20  # K5 calls a reading
KERNELS = {"chain": "field_bwd_chain_kernel", "dw": "field_dw_kernel", "sums": "sum_rows_kernel"}
# case -> (NerfMLPSpec keywords or "proposal", points)
CASES = {
    "stock-coarse": ({}, 65_536),
    "stock-fine": ({}, 196_608),
    "proposal-2x64": ("proposal", 65_536),
    "student-6x192": ({"depth": 6, "width": 192}, 196_608),
    "student-4x128": ({"depth": 4, "width": 128, "input_ch": 51}, 196_608),
}


def spec_of(case: str):
    from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    kw = CASES[case][0]
    return proposal_spec(6) if kw == "proposal" else NerfMLPSpec(**kw)


def build(sources: dict, shapes) -> dict:
    """{(label, shape): loaded library}, every source compiled once per
    shape by one nvcc process, all started together."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        for w, f, v in shapes:
            lib = os.path.join(OUT_DIR, f"train_field_{label}_w{w}f{f}v{v}.so")
            flags = (f"-DFIELD_WIDTH={w}", f"-DFIELD_PTS_FREQS={f}", f"-DFIELD_VIEW_FREQS={v}")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", os.path.dirname(src), "-o", lib, src]
            procs[label, (w, f, v)] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def case_inputs(case: str, device, seed: int):
    """(meta, weight stream, pts, views, g_raw, n) of one case."""
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
    from nerf_workspaces_explorer_tpu_torch.models.mlp import init_nerf_params
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    n = CASES[case][1]
    spec = spec_of(case)
    g = torch.Generator(device="cpu").manual_seed(seed)
    inputs, meta = ff.build_kernel_inputs(params_from_numpy(init_nerf_params(g, spec), device), spec)
    pts = (torch.randn(3, n, generator=g) * 2.0).to(device)
    views = torch.randn(3, n, generator=g)
    views = (views / views.norm(dim=0, keepdim=True)).to(device)
    g_raw = torch.zeros(8, n)
    g_raw[:4] = torch.randn(4, n, generator=g) * 1e-3
    return meta, ff.pack_field_stream(inputs, meta), pts, views, g_raw.to(device), n


def launcher(lib, meta, ws, pts, views, g_raw, n):
    """A K5 call of `lib`'s kernels on buffers of its own; returns the [dW,
    db] buffer it writes."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    device = pts.device
    sizes = [ctypes.c_longlong() for _ in range(3)]
    _build.check(_build.entry(lib, "field_backward_sizes")(meta["n_layers"], ff._skip_layer(meta), n,
                                                           *[ctypes.byref(s) for s in sizes]),
                 "field_backward_sizes")
    n_scratch, n_dw, n_db = (int(s.value) for s in sizes)
    scratch = torch.empty((n_scratch,), dtype=torch.bfloat16, device=device)
    dbpart = torch.empty((2 * -(-n // 128), n_db), dtype=torch.float32, device=device)
    part = torch.empty((-(-n // ff.DW_CHUNK), n_dw), dtype=torch.float32, device=device)
    grads = torch.empty((n_dw + n_db,), dtype=torch.float32, device=device)
    args = ff._launch_args(ws, meta, device, backward=True)
    fn = _build.entry(lib, "field_backward_launch")
    stream = _build.stream_handle(device)

    def call():
        code = fn(*args, pts.data_ptr(), views.data_ptr(), g_raw.data_ptr(), scratch.data_ptr(), dbpart.data_ptr(),
                  part.data_ptr(), grads.data_ptr(), grads.data_ptr() + 4 * n_dw, n, ff.DW_CHUNK, stream)
        _build.check(code, "field_backward_launch")
        return grads

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


def kernel_ms(fn, reps: int = REPS) -> dict:
    """{kernel key: device ms a call} from a profiler trace of reps calls."""
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import kernel_name

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {key: 0.0 for key in KERNELS}
    for e in prof.key_averages():
        name = kernel_name(e.key)
        for key, kernel in KERNELS.items():
            if name == kernel:
                us[key] += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    return {key: v / 1e3 / reps for key, v in us.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", action="append", default=[], metavar="LABEL=PATH",
                        help="another version of train_field.cu to time beside the repo's")
    parser.add_argument("--cases", default=",".join(CASES), help="comma-separated cases of CASES")
    parser.add_argument("--rounds", type=int, default=2, help="rounds of A B ... B A")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_field: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

    cases = args.cases.split(",")
    sources = {"repo": os.path.join(ROOT, "nerf_workspaces_explorer_tpu_torch", "csrc", "train_field.cu")}
    for item in args.against:
        label, _, path = item.partition("=")
        sources[label] = os.path.abspath(path)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    device = torch.device("cuda")
    shapes = sorted({ff._shape(ff.field_meta(spec_of(c))) for c in cases})
    libs = build(sources, shapes)
    labels = list(sources)
    order = labels + labels[::-1]

    summary = {"card": card, "reps": REPS, "cases": {}}
    for case in cases:
        meta, ws, pts, views, g_raw, n = case_inputs(case, device, args.seed)
        shape = ff._shape(meta)
        calls = {label: launcher(libs[label, shape], meta, ws, pts, views, g_raw, n) for label in labels}
        first = calls[labels[0]]().clone()
        torch.cuda.synchronize()
        equal = {}
        for label in labels[1:]:
            out = calls[label]()
            torch.cuda.synchronize()
            equal[label] = bool(torch.equal(out.view(torch.int32), first.view(torch.int32)))
        got = {label: [] for label in labels}
        for _ in range(args.rounds):
            for label in order:
                got[label].append(dict(k5=events_ms(calls[label]), **kernel_ms(calls[label])))
        rows = {}
        for label, reads in got.items():
            rows[label] = {k: float(np.median([x[k] for x in reads])) for k in reads[0]}
            rows[label]["bits_equal_to_" + labels[0]] = equal.get(label, True)
            text = "; ".join(f"{k} " + ", ".join(f"{x[k]:.4f}" for x in reads) for k in reads[0])
            print(f"K5 {case} ({n} points) {label}: {text}; bits equal to {labels[0]}: {equal.get(label, True)}",
                  flush=True)
        summary["cases"][case] = rows
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
