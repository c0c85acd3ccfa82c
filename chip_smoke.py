#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `nerf_workspaces_explorer_tpu_torch/
csrc/` and drives the port's paths in this order: serving, the explorer
app, the strip-pipelined frame, the presets, the two profiling scripts'
kernels, training from a Replica-layout sequence, the device mesh,
training, distillation, the serving quality gate, and mip-NeRF 360 at its
published widths (`mip360_phase`: K10-K13 and their launches in one
profiled frame, each held against its plain version on a frame's own
inputs, their bounds, 512 rays against the plain float32 reference). After the build it
prints every library's ptxas lines and fails on a spill in a served render
kernel, a training field or the int4 probe, on a served render kernel
whose wgmma products ptxas serialized (C7520; the count per library), and
on a training field whose chain kernel (K5's first) writes the backward's
scratch without TMA tensor stores (UTMASTG in its SASS), spills or carries
C7520 (its TMA and 128-bit global stores counted per library).

Serving: holds K1-K3 against their plain PyTorch versions on the card at the
main path's shapes (one 320x240 frame: 76,800 rays, 8x256 coarse+fine nets
from `assets/bench/synth_hier.npz`, 64 coarse + 128 importance samples),
times them with CUDA events (one reading of 20 launches for K2, K6 and the
launch floor, an empty kernel through the same binding; for these three also
the median of 5 such readings and one CUDA graph of 20), then serves floor-plan clicks through
`Workspace.render_image` at precision="fast" and checks each frame against
the fp32 parity render (SSIM >= 0.99, the repo's gate for bf16 serving,
reports/reference_parity_320x240.md) and that every kernel of the path ran
once per frame. A renderer's first single frame runs eagerly and captures
its frame graph; later frames are replays, which call no kernel wrapper
(`LAUNCHES` counts wrapper calls, the capture's too), so their kernels are
counted from a profiler trace of one more frame of each pose.

App: the real `app/gui_qt.py` and `app/gui_tk.py` classes on the duck-
typed toolkits of `tests/fake_toolkits.py` (a PPM `PhotoImage` stand-in and
a root whose `after` queues, pumped on this thread), over office_tokyo and
office_geneve served from synth_hier at the reference preset, precision
"fast": the placeholders that `ensure_assets` writes into a temporary
directory read back byte-equal; landing, explorer, a click on the plan at
serving's spots, the four turn buttons, both back flows, each installed
frame byte-equal to `Workspace.render_image` of the same click and a replay
of the frame graph the explorer's warm-up captured, and a traced click
running K1, K2, K3 once beside its preview's launches; on Tk's
worker threads the same, two overlapping requests (only the later frame
installed, equal to its serial render) and a failing render raised on the
UI thread; warm ms from click to installed frame (median of 6) beside
`Workspace.render_image`'s.

Replica: 100 frames of the room walkthrough at Replica's 640x480 (ground
truth marched at REPLICA_GT_SAMPLES; 100 of a Sequence_1's ~900 frames,
for time) written by `utils/png.py` in Replica's layout (8-bit RGB,
16-bit millimetre depth, `traj_w_c.txt`; frame i's rows all filter i % 5,
every 10th frame's rows cycling through the five); every file decodes
exactly to what was written; `Trainer("office_tokyo")` with no data loads
the splits (every 5th frame, +2) resized to 320x240, which equal the
loader's resize of the files, then takes 300 steps through K4/K5 (two K4
and two K5 calls a step, the loss falling) and the same 300 as CUDA-graph
replays of 10 (losses equal to eager to 1e-6); decode and resize s a
frame, load s a split and ms a step printed.

Mesh: `parallel/dryrun.py::dryrun_multigpu` at full width (8x256 nets, 64
+ 128 samples, the 1,024-ray step; a 320x240 frame of rays) on
`data_mesh(1)`, on meshes repeating cuda:0 two and four times, and on
`data_mesh(2)` where the machine has two cards: a data-parallel step (its
gradient held against the single-device step on the concatenated batch
with the same draws, rel < 0.08, the fused field's bound), the sharded
plain render, the fused leg per shard against it, and the int8 + proposal
serving configuration, a 6x192@10f turbo student and the stride-4 lattice
each sharded against single (max |err| < 5e-3, and whether the uint8
frames are byte-equal); then three calls of K = 10 data-parallel steps as
`StepGraph` replays (`Trainer(mesh=, steps_per_call=10)`'s path: one graph
of the ten steps on one card) against the same steps eagerly, losses equal
to 1e-6. Every shard must launch each kernel of its leg once (K1/K7
density, K2/K6, K3/K7 full) and K4/K5 twice a step (the graph leg's first
call: its ten warm-up steps and the capture; its replays launch nothing
through the wrappers); warm ms of the sharded frame and the data-parallel
step beside their unsharded counterparts, and of a K = 10 graph call over
10 beside the graphed single-device step.

Strips: serves the main path's first click as a strip-pipelined frame
(`render_pose_uint8_pipelined`, 6 strips of 40 rows): bytes equal to the
blocking frame at eps 0, one density pass, placement and fine pass per
strip, warm ms beside the blocking frame's.

Presets: builds the render kernel for every network shape of the in-repo
checkpoints (64/F=6, 128/F=8, 192/F=10, 256/F=10) in its bf16, int8-trunk and
int8 modes; holds K6 (importance-only placement) against its plain version
at the turbo shapes (64 proposal samples, 48 importance samples, the 4,800
stride-4 lattice rays of a real proposal pass) and at synth_hier's
fast-preset shapes (64, 128, 76,800 rays), each with its bound, plain time
and CUDA-graph time, K1/K3 at the proposal (2x64@6f)
and student (6x192@10f, all 76,800 rays) shapes, and K7 (int8-trunk and
int8, density-only and full) on synth_hier's 8x256 nets and the turbo nets,
all at eps 0 (the kernel and its plain version read one set of int8
parameters; tests/test_torch_quantize.py holds that set equal to the JAX
package's on the CPU). Then serves 320x240 frames: synth_hier at
the reference preset (int8, int8-trunk) and the fast preset (bf16) on the
three clicks; the room fixture (`room_proposal.npz`, depth range 0.1-8) at
the fast preset with its proposal net and at the turbo preset (bf16, int8)
on three walkthrough poses; for each row the warm ms per frame (median of
6), exactly one density pass, one placement and one fine pass per frame,
SSIM >= 0.99 at stride 1 against the fp32 parity frame of the same preset
and pose, and for the stride-4 rows the SSIM against stride 1 and block
corners equal to stride 1's at eps 0; and times one preview of each kind.

The fast preset's density pass takes the caller's eps (1e-3) and stops a
32-ray block only at T <= min(eps, 1e-5 / S) (csrc/fused_render.cu); the
presets phase prints, from each click's eps-0 density weights, how many of
the JAX kernel's 4,096-ray tiles would stop at 1e-3, and its fast-preset
row holds SSIM >= 0.99 as every row does.

Ablation (K8): builds the ablation library, holds each ablation mode against
its plain version on 4,096 rays x 48 samples of the 4x128@8f student
(`assets/bench/synth_proposal.turbo.npz`, int8 trunk and heads), then runs
`scripts/profile_torch_fine_ablation.py`'s attribution at 640x480 x 48 and
prints its table. int4 (K9): both legs of `scripts/probe_int4_torch.py`
against their plain versions and numpy, timed three ways (one events
reading of 50 launches, the median of 5 such, one CUDA graph of 20) beside
the launch floor read the same ways and beside `torch.matmul` of the
widened matrix, then the probe's verdicts; the `int4_probe` library must
show wgmma (HGMMA), no mma.sync (HMMA) and no spill.

Training: on the room scene at 320x240 (60-frame walkthrough, every 5th
frame a train view, +2 a test view: 12 and 12) with the stock config (8x256
nets, 1024 rays of 64 + 128 samples), holds K4 (field forward) and K5
(field backward) against the plain field on one real step's points, checks
that two K5 launches agree bit for bit, times both (on the stream packed
once, beside the pack itself and beside the same products as bf16
`torch.matmul` calls), then trains 300 steps through `Trainer` with the
fused field (two K4 and two K5 calls per step, loss falling), renders two
test views through K1-K3, trains the same 300 steps with the plain field
(test-view PSNR within 1 dB), resumes a fresh Trainer from the step-150
checkpoint (its next loss equal to 1e-6), and trains the 300 steps again at
steps_per_call=10, as 30 replays of a CUDA graph of 10 steps (losses equal
to the eager run's to 1e-6, the same launch counts, ms/step beside the
eager run's). Then proposal training, the same config with the 2x64@6f/2f
proposal net in the coarse net's place (the interlevel loss): K4/K5 at
that shape against the plain field on one real step's 65,536 proposal
points (the same gates; two K5 launches bit-equal; times also as one CUDA
graph of 20), 300 fused steps (one K4 and one K5 call a step through each
of the two libraries, loss falling), test-view PSNR within 1 dB of 300
plain steps, the graph leg at steps_per_call=10 (losses equal to eager to
1e-6), 300 `--fast-preset` steps (importance-only placement), and the
step-300 checkpoint served at the fast preset for one room test view (SSIM
>= 0.99 against its parity frame at stride 1; stride 4's SSIM to stride 1
printed). The training field builds as one library per network shape
(`train_field_w256f10v4`, `train_field_w64f6v2`, and the students'
`train_field_w192f10v4`, `train_field_w128f8v4`); each must show no
ptxas spill and wgmma (HGMMA) with no mma.sync (HMMA) in its SASS; every
kernel of the `importance_merge` library (K2/K6) a 0-byte stack frame and
no spill.

Distillation: the room recipe of `scripts/make_bench_fixture.py` cut to
DISTILL_STEPS of its 50,000 steps. The teacher is `room_proposal.npz`
(2x64@6f proposal, 8x256 fine, depth 0.1-8), rendered through K1-K3 at
128x96 (one K1, K2 and K3 a view) at the walkthrough's 180 train poses, 128
off-tour coverage poses and the 36 probe-grid poses, held out. K4/K5 at
each student's library (`train_field_w192f10v4`, the default 6x192@10f;
`train_field_w128f8v4`, the 4x128@8f speed student) against the plain fp32
field on one real distillation step's 196,608 fine points (the stock
gates; times also as one CUDA graph of 20), with each library's ptxas
lines, spill gate and SASS counts. Then `distill_student` with the fused
field (one K4 and one K5 call a step through the student's library and
through the proposal net's; the photometric loss falling) and with the
plain field on the same teacher views: `psnr_vs_teacher` on the held-out
views (rendered through K1/K6/K3) within 1 dB of each other; the same
student steps as CUDA-graph replays of GRAPH_K steps (losses equal to the
eager run's to 1e-6, ms a step beside it); the speed
student's shorter run; the sidecar written with `save_turbo_checkpoint`,
its metadata read back equal, served at the turbo preset (bf16) at 320x240
on the room's spot (warm ms a frame, one K1, K6 and K3 a frame, SSIM >=
0.99 against its parity frame at stride 1).

Quality: `scripts/validate_quality_torch.py` at the JAX gate's recipe and
thresholds (`--steps 3000 --proposal --fast-preset --prop-subsample 4`: the
96x128 orbit, 12 train / 3 test views, the stock config; seed 0), its legs
counted: each trains through K4/K5 (one step a call at every 500th, CUDA-
graph replays of 10 between) and renders the test views through K1/K2/K3,
the int8 set through K7 and the fast preset through K6/K7; per leg the test
PSNR/SSIM against ground truth, the fused and int8 fidelities against the
fp32 pipeline, the fast-preset PSNRs, ms a step and launches. Every gate
that holds this run's models and kernels must pass (PSNR, fused and int8
fidelity, fast-preset and stride drops). The proposal-against-hierarchical
drop compares two independent trainings on three test views; its gap moves
by more than the gate's 0.7 dB from one Trainer seed to the next
(`scripts/quality_seed_spread_torch.py`), so the phase prints the gate's
verdict as it is and trains both legs again at seeds 1-3: the mean gap over
seeds 0-3 must stay above -0.7 dB.

Its last two lines are a JSON object with one entry per kernel (K1-K9; the
new K1/K3 shapes, each served K7 mode, each K8 row and K9 leg, and K4/K5 at
the proposal shape and at each student's have entries of their own) and the result line `{"ok": true, "device": {...}}`. Any
failure raises and exits nonzero; without a CUDA card, or outside the
repository, it exits 2 and prints no result.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "nerf_workspaces_explorer_tpu_torch"
CKPT = os.path.join(HERE, "assets", "bench", "synth_hier.npz")

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BF16_ATOL = 5e-3  # bf16 kernels (tests/test_golden.py:52, tests/test_pallas_train.py:40)
BF16_GRAD_REL = 0.08  # bf16 field gradients vs fp32 (tests/test_pallas_train.py:54-56)
TRAIN_SIZE = (320, 240)  # width, height of the room scene's views
TRAIN_FRAMES, TRAIN_STRIDE = 60, 5  # walkthrough frames; every 5th trains, +2 tests: 12 and 12
TRAIN_EVAL_VIEWS = 2  # test views rendered after training
TRAIN_STEPS = 300
TRAIN_WINDOW = 20  # steps averaged at each end of a run for "loss falls"
WARM_SKIP = 10  # first steps left out of the warm ms per step
RESUME_STEP = 150
GRAPH_K = 10  # steps per CUDA-graph replay in the training phase's graph leg
# The graph leg's last calls, traced to count the kernels they replay. One:
# a trace of three replays (30 steps) came back short of K4/K5 kernels in
# one of nine smokes on the H100 while the replays' losses were exact, so
# the trace lost records; a third of the events leaves it less to lose.
GRAPH_PROFILED_CALLS = 1
TRAIN_KERNELS = {  # K4/K5 counter -> the CUDA kernels it counts (csrc/train_field.cu)
    "forward": ("field_fwd_kernel",), "backward": ("field_bwd_chain_kernel",),
    "backward_kernels": ("field_bwd_chain_kernel", "field_dw_kernel", "sum_rows_kernel"),
}
PSNR_GAP_DB = 1.0  # fused against plain field after TRAIN_STEPS
SSIM_GATE = 0.99  # bf16 serving vs fp32 (reports/reference_parity_320x240.md)
EPS = 1e-3  # the renderer's early-stop eps on the main path
CLICKS = [  # (office class name, rel_x, rel_y, horizontal angle, vertical angle)
    ("OfficeTokyoWorkspace", 0.5, 0.5, 0, 0),
    ("OfficeTokyoWorkspace", 0.5, 0.5, 60, 0),  # same spot, another yaw
    ("OfficeGeneveWorkspace", 0.4, 0.6, 30, -10),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int = 20, runs: int = 5) -> float:
    """Median of `runs` readings of `time_ms(fn, reps)`: for a kernel of a
    few microseconds each reading is mostly the host's launch path, whose
    time varies from reading to reading."""
    return float(np.median([time_ms(fn, reps) for _ in range(runs)]))


def graph_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls captured as one CUDA graph
    and replayed: its kernels back to back, without the host's gaps between
    launches that `time_ms` also counts for a kernel of a few microseconds."""
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


def render_macs(kp, density_only: bool):
    """(MACs per evaluated sample, MACs per ray) of the fused render kernel."""
    per_sample = sum(w.shape[0] * w.shape[1] for w in (*kp.w_layers, *kp.w_skip_enc)) + kp.width
    if density_only:
        return per_sample, 0
    half = kp.width // 2
    per_sample += kp.width * kp.width + half * kp.width + 3 * half
    return per_sample, half * kp.w_view_enc.shape[1]


def weight_bytes(kp) -> int:
    ts = (*kp.w_layers, *kp.w_skip_enc, *kp.b_layers, kp.w_fa, kp.b_fa, kp.w_view_h,
          kp.w_view_enc, kp.b_view, kp.w_rgb, kp.b_rgb)
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def full_pass_stats(kp, samples: int, ms: float, flops: float, bound: float, peak: float) -> dict:
    """A full pass's achieved rate on the samples it evaluated (TFLOP/s for
    bf16, TOP/s for int8), its share of the bound, and the weight bytes its
    blocks streamed from L2: steps evaluated x the stream of one step
    (`ops/fused_render.py::weight_stream`)."""
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr

    per_step = sum(e[2] for e in fr.weight_stream(kp).full)
    steps = samples // fr.STEP_POINTS
    return dict(achieved_tflops=flops / (ms * 1e-3) / 1e12, bound_share=bound / ms,
                peak_share=flops / (ms * 1e-3) / peak, stream_bytes_per_step=per_step,
                stream_bytes_per_frame=steps * per_step)


def stats_text(st: dict, unit: str) -> str:
    return (f"{st['achieved_tflops']:.1f} {unit} on the evaluated samples ({st['peak_share']:.1%} of peak, "
            f"{st['bound_share']:.1%} of the bound), weight stream {st['stream_bytes_per_step']} B a step, "
            f"{st['stream_bytes_per_frame'] / 1e9:.2f} GB a frame from L2")


def products_matmul_ms(kp, n_points: int, chunk: int = 1 << 18) -> float:
    """Yardstick of the products alone: the net's layer products (trunk,
    skip, feature+alpha, view, rgb) as a chain of bf16 `torch.matmul` calls
    over n_points, in chunks of `chunk` points. The port never calls it."""
    dev, w = kp.w_layers[0].device, kp.width
    ws = [t.to(torch.bfloat16) for t in (*kp.w_layers, *kp.w_skip_enc, kp.w_fa[: w + 16], kp.w_view_h, kp.w_rgb)]
    depth = len(kp.w_layers)
    skip_layer = kp.skips[0] + 1 if kp.skips else -1
    x = torch.randn(chunk, ws[0].shape[1], device=dev).to(torch.bfloat16) * 0.1
    sizes = [chunk] * (n_points // chunk) + ([n_points % chunk] if n_points % chunk else [])

    def chain(e):
        h = e
        for i in range(depth):
            y = torch.matmul(h, ws[i].T)
            if i == skip_layer:
                y = y + torch.matmul(e, ws[depth].T)
            h = y
        f = torch.matmul(h, ws[-3].T)
        return torch.matmul(torch.matmul(f[:, :w], ws[-2].T), ws[-1].T)

    return time_ms(lambda: [chain(x[:n]) for n in sizes], 3)


def served_render_spills(names) -> list:
    """(library, kernel, ptxas line) of every served `render_kernel` that
    ptxas reports with spill stores or loads."""
    return [x for name in names if name.startswith("fused_render_w") for x in library_spills(name, "render_kernel")]


NO_SPILLS = r"\b0 bytes spill stores, 0 bytes spill loads"


def ptxas_kernel_lines(log: str) -> list:
    """(kernel, line) for each line of nvcc's -Xptxas -v output: a line that
    names a function in quotes (an entry being compiled, a C75xx warning)
    belongs to it, any other to the entry being compiled."""
    out, entry = [], ""
    for line in log.splitlines():
        named = line.split("'")[1] if line.count("'") >= 2 else ""
        if "Compiling entry" in line:
            entry = named or line
        out.append((named or entry, line))
    return out


def served_render_serialized(names, read_log=None) -> list:
    """(library, kernel, ptxas line) of every served `render_kernel` whose
    ptxas log carries a C7520 line: ptxas serialized its wgmma products.
    `read_log` (library name -> nvcc's output) defaults to the built
    library's log."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    read_log = read_log or _build.build_log
    return [(name, kernel, line.strip()) for name in names if name.startswith("fused_render_w")
            for kernel, line in ptxas_kernel_lines(read_log(name)) if "(C7520)" in line and "render_kernel" in kernel]


def library_spills(name: str, kernel: str = "") -> list:
    """(library, kernel, ptxas line) of every kernel of library `name` whose
    entry contains `kernel` that ptxas reports with spill stores or loads."""
    import re

    from nerf_workspaces_explorer_tpu_torch.ops import _build

    return [(name, entry, line.strip()) for entry, line in ptxas_kernel_lines(_build.build_log(name))
            if "spill stores" in line and kernel in entry and not re.search(NO_SPILLS, line)]


def library_stack_or_spills(name: str):
    """(kernels, bad): the number of kernels of library `name` that ptxas
    reports on, and (kernel, ptxas line) of each whose line is not `0 bytes
    stack frame, 0 bytes spill stores, 0 bytes spill loads`."""
    import re

    from nerf_workspaces_explorer_tpu_torch.ops import _build

    lines = [(entry, line) for entry, line in ptxas_kernel_lines(_build.build_log(name)) if "stack frame" in line]
    return len(lines), [(entry, line.strip()) for entry, line in lines
                        if not re.search(r"\b0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", line)]


def library_sass(name: str):
    """A built library's SASS (cuobjdump -sass); None without cuobjdump."""
    from nerf_workspaces_explorer_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True, text=True, check=True,
                          timeout=300).stdout


def sass_counts(name: str):
    """Counts of the tensor-core instructions in a library's SASS (cuobjdump):
    HGMMA/IGMMA (wgmma, bf16/int8) and HMMA/IMMA (mma.sync, which WMMA
    compiles to); None without cuobjdump."""
    import re

    sass = library_sass(name)
    if sass is None:
        return None
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "IGMMA", "HMMA", "IMMA")}


def sass_functions(sass: str) -> dict:
    """A library's SASS by function: cuobjdump's `Function : <name>`
    sections."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


CHAIN_KERNEL = "field_bwd_chain_kernel"  # K5's first kernel, csrc/train_field.cu


def field_chain_stores(sass: str, log: str):
    """The chain kernel of one training field library, from the library's
    SASS and nvcc's -Xptxas -v output: ({"tma_stores": its UTMASTG
    instructions, "stg128": its 128-bit global stores}, failures). It fails
    when the kernel issues no TMA store, spills or carries C7520 (ptxas
    serialized its wgmma products); other kernels' lines do not count."""
    import re

    code = "\n".join(text for fn, text in sass_functions(sass).items() if CHAIN_KERNEL in fn)
    counts = {"tma_stores": len(re.findall(r"\bUTMASTG\b", code)),
              "stg128": len(re.findall(r"\bSTG\.E(?:\.\w+)*\.128\b", code))}
    failures = []
    if not code:
        failures.append(f"no {CHAIN_KERNEL} in the SASS")
    elif counts["tma_stores"] == 0:
        failures.append(f"{CHAIN_KERNEL} issues no TMA store")
    for kernel, line in ptxas_kernel_lines(log):
        if CHAIN_KERNEL not in kernel:
            continue
        if "spill stores" in line and not re.search(NO_SPILLS, line):
            failures.append(f"{CHAIN_KERNEL} spills: {line.strip()}")
        if "(C7520)" in line:
            failures.append(f"{CHAIN_KERNEL} serialized: {line.strip()}")
    return counts, failures


def require(ok: bool, what: str) -> None:
    """A check that holds under `python -O` too."""
    if not ok:
        raise AssertionError(what)


def merge_check(out, ref, z, u1_rows=slice(-3, -1)):
    """Importance placement: equal up to the CDF's fp32 summation order.
    Flips to a neighbouring interval on < 0.5% of depths, each within one
    coarse bin, outside the rows where the u = 1 quantile may sit at either
    end of the last bin: merged rows -3 and -2 (tests/
    test_torch_importance_merge.py::assert_merge_close), the last row without
    the merge. On those rows each ray's depths move by at most its own last
    bin. Returns (max |err|, flips on all rows, flips off the u = 1 rows)."""
    err = (out - ref).abs()
    rows = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
    rows[u1_rows] = False
    flips = float((err > 1e-4).float().mean())
    flips_rest = float((err[rows] > 1e-4).float().mean())
    bin_w = float(torch.diff(z, dim=0).max())
    mid = 0.5 * (z[1:] + z[:-1])
    last_bin = mid[-1] - mid[-2]  # [R]
    u1_excess = float((err[u1_rows] - last_bin).max())
    if flips_rest >= 5e-3 or float(err[rows].max()) > bin_w + 1e-4 or u1_excess > 1e-4:
        raise AssertionError(f"importance kernel: flips {flips_rest:.4%} off the u = 1 rows, max err "
                             f"{float(err[rows].max())} there; u = 1 rows beyond their ray's last bin by {u1_excess}")
    if not bool((torch.diff(out, dim=0) >= 0).all()):
        raise AssertionError("importance kernel output is not sorted")
    return float(err.max()), flips, flips_rest


def field_macs(spec):
    """(forward, backward) multiply-adds per point of the training field: the
    forward's products, and the backward's recomputed forward plus its
    input-gradient products (none into the encodings) plus one weight-
    gradient product per weight."""
    w, half = spec.width, spec.width // 2
    fwd = sum(i * o for i, o in spec.layer_dims()) + w * w + w + (w + spec.input_ch_views) * half + half * 3
    dx = (spec.depth - 1) * w * w + w * w + w + w * half + half * 3
    return fwd, 2 * fwd + dx


def named_leaves(tree, prefix=""):
    """[(dotted name, leaf)] in `tree_leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in named_leaves(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def field_products_matmul_ms(inputs, n: int, backward: bool) -> float:
    """The training field's products over n points as bf16 `torch.matmul`
    calls on the card (a yardstick; the port never calls them): the
    forward's layer products (K4); with `backward`, K5's recomputed forward,
    its input-gradient products and one dW = G^T H per weight. Same shapes
    as the kernels' products, random operands."""
    dev = inputs["w0"].device
    gen = torch.Generator(device=dev).manual_seed(0)
    w = {k: v for k, v in inputs.items() if k.startswith("w")}
    depth = sum(1 for k in w if k[1:].isdigit())
    skip = [k for k in w if k.startswith("wskip")]
    act = {c: torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16) for c in (16, 32, 64, 128, 256)}
    mats = [w["w0"]] + [w[f"w{i}"] for i in range(1, depth)] + [w[k] for k in skip]
    mats += [w["w_feature"], w["w_view_h"], w["w_view_enc"]]
    if not backward:
        mats += [w["w_alpha"], w["w_rgb"]]
    else:
        mats += [w["w_rgb_t"], w["w_view_h_t"], w["w_feature_t"], w["w_alpha_t"]]
        mats += [w[f"w{i}_t"] for i in range(1, depth)]
    grads = [(m.shape[0], m.shape[1]) for m in mats if backward]

    def run():
        for m in mats:
            torch.matmul(act[_pow2(m.shape[1])][:, : m.shape[1]], m.T)
        for rows, cols in grads:  # dW [rows, cols] = G^T H over the points
            torch.matmul(act[_pow2(rows)][:, :rows].T, act[_pow2(cols)][:, :cols])

    return time_ms(run, 3)


def _pow2(c: int) -> int:
    return next(p for p in (16, 32, 64, 128, 256) if p >= c)


def zero_launches(*counters) -> None:
    for d in counters:
        for k in d:
            d[k] = 0


def render_pass(key: str) -> str:
    """The pass a render or placement wrapper's `LAUNCHES` key counts:
    "density_only", "placement" (merged or importance-only) or "full"."""
    return "placement" if key.startswith("importance") else key.split("_int8")[0]


def traced_render_passes(fn) -> dict:
    """The render kernels the card ran during `fn()`, by `render_pass`, from
    a profiler trace: `render_kernel`'s density and full passes (its last
    template argument, DENSITY_ONLY; every precision) and
    `importance_merge_kernel`. A frame-graph replay calls no wrapper, so
    the kernels of replayed frames are counted here."""
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import kernel_name

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    ran = {"density_only": 0, "placement": 0, "full": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        name = kernel_name(e.key)
        if name == "render_kernel":
            ran["density_only" if e.key.split("(")[0].rstrip("> ").endswith("true") else "full"] += e.count
        elif name == "importance_merge_kernel":
            ran["placement"] += e.count
    return ran


def train_config():
    """The stock config on the room scene: its depth range (cli/train.py
    --scene room), no console print, checkpoint or eval render on a cadence
    (the phase saves and renders itself)."""
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config

    cfg = load_config(office_name="tokyo")
    return dataclasses.replace(
        cfg,
        rendering=dataclasses.replace(cfg.rendering, depth_range=(0.1, 8.0)),
        logging=dataclasses.replace(cfg.logging, step_log_print=0, step_save_ckpt=0,
                                    step_render_test=0, step_render_train=0),
    )


def field_leg(device, trainer, nets, specs, settings, spec, cfg, graph=False, label=""):
    """K4 and K5 against the fp32 plain field on the points of one real step
    (step 0's draws on the trainer's views, its initial weights): the
    plain step's autograd gives the raw maps, their cotangents and every
    leaf's gradient. `nets` are the nets held ("coarse" and "fine", or
    "proposal"); with a proposal net the loss is the proposal step's
    (interlevel + fine MSE). The proposal net's times, and every net's with
    `graph`, are also read as one CUDA graph of 20; `label` heads the
    printed line. Returns {net: checks, times and bounds}."""
    from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
    from nerf_workspaces_explorer_tpu_torch.ops import _build
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.render.pipeline import render_ray_bundle
    from nerf_workspaces_explorer_tpu_torch.render.proposal import interlevel_loss
    from nerf_workspaces_explorer_tpu_torch.render.volume import sigma_to_weights
    from nerf_workspaces_explorer_tpu_torch.train.loop import step_seed
    from nerf_workspaces_explorer_tpu_torch.train.step import draw_step, sample_training_rays
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import img2mse

    train_rgbs = trainer._train_rgbs
    gen = torch.Generator(device=device).manual_seed(step_seed(0, 0))
    draws = draw_step(gen, train_rgbs.shape[0], train_rgbs.shape[1], cfg.rendering.n_rays, settings, device)
    rays, gt = sample_training_rays(trainer.rays_train, train_rgbs, draws.img_idx, draws.pix_idx)
    out = render_ray_bundle(trainer.params, rays, settings, spec=spec, draws=draws.render, full_outputs=True)
    if settings.use_proposal:
        w_prop = sigma_to_weights(out["raw_coarse"][..., 3], out["z_vals_coarse"], rays.dirs)
        w_fine = sigma_to_weights(out["raw_fine"][..., 3], out["z_vals_fine"], rays.dirs)
        loss = interlevel_loss(out["z_vals_coarse"], w_prop, out["z_vals_fine"], w_fine)
    else:
        loss = img2mse(out["rgb_coarse"], gt)
    loss = loss + img2mse(out["rgb_fine"], gt)
    raw_key = {"coarse": "coarse", "proposal": "coarse", "fine": "fine"}
    leaves = {k: tree_leaves(trainer.params[k]) for k in nets}
    grads = torch.autograd.grad(loss, [out[f"raw_{raw_key[k]}"] for k in nets] + [x for k in nets for x in leaves[k]])
    g_raws = dict(zip(nets, grads[: len(nets)]))
    ref_grads, at = {}, len(nets)
    for k in nets:
        ref_grads[k] = grads[at: at + len(leaves[k])]
        at += len(leaves[k])
    res = {}
    for net in nets:
        net_spec = specs[net]
        mac_fwd, mac_bwd = field_macs(net_spec)
        z = out[f"z_vals_{raw_key[net]}"]
        n = z.numel()
        pts_t = (rays.origins[:, None, :] + rays.dirs[:, None, :] * z[..., None]).reshape(n, 3).T.contiguous()
        views_t = rays.viewdirs[:, None, :].expand(-1, z.shape[1], 3).reshape(n, 3).T.contiguous()
        g_raw = torch.cat([g_raws[net].reshape(n, 4).T, torch.zeros(4, n, device=device)]).contiguous()
        inputs, meta = ff.build_kernel_inputs(trainer.params[net], net_spec)
        raw = ff.field_forward(inputs, meta, pts_t, views_t)
        torch.cuda.synchronize()
        raw_ref = out[f"raw_{raw_key[net]}"].detach().reshape(n, 4).T
        k4_err = float((raw[:4] - raw_ref).abs().max())
        require(bool(torch.isfinite(raw).all()), f"K4 {net}: non-finite output")
        require(k4_err <= BF16_ATOL, f"K4 {net}: max |err| {k4_err} against the fp32 field")
        kg = ff.field_backward(inputs, meta, pts_t, views_t, g_raw)
        kg2 = ff.field_backward(inputs, meta, pts_t, views_t, g_raw)
        raw2 = ff.field_forward(inputs, meta, pts_t, views_t)
        torch.cuda.synchronize()
        same = all(torch.equal(kg[k], kg2[k]) for k in kg)
        require(same, f"K5 {net}: two launches on the same inputs differ")
        require(torch.equal(raw, raw2), f"K4 {net}: two launches on the same inputs differ")
        errs = []
        for (name, a), b in zip(named_leaves(ff.grads_to_tree(kg, meta)), ref_grads[net]):
            require(tuple(a.shape) == tuple(b.shape), f"K5 {net} {name}: shape {tuple(a.shape)}")
            abs_err = float((a - b).abs().max())
            errs.append((abs_err / (float(b.abs().max()) + 1e-30), abs_err, name))
        worst = max(errs)
        require(worst[0] < BF16_GRAD_REL, f"K5 {net} {worst[2]}: rel err {worst[0]} against fp32 autograd")
        # K4 and K5 as a training step runs them (ops/fused_field.py
        # `_FusedField`): K4 = the pack of the net's leaves into the weight
        # stream, then the kernel; K5 = its launches on that stream, then the
        # gather of the gradients into leaf order. The kernels alone, on a
        # stream packed once, and the pack alone are timed beside them; at
        # the proposal shape also as one CUDA graph of 20 (the device alone).
        leaves_net = tree_leaves(trainer.params[net])
        ws, grad_index = ff._pack_leaves(trainer.params[net], leaves_net, net_spec, meta)

        def k4_step():
            packed, _ = ff._pack_leaves(trainer.params[net], leaves_net, net_spec, meta)
            return ff.field_forward_packed(packed, meta, pts_t, views_t)

        def k5_step():
            flat, _ = ff._field_backward_flat(ws, meta, pts_t, views_t, g_raw)
            return flat.index_select(0, grad_index)

        k4_kernel = lambda: ff.field_forward_packed(ws, meta, pts_t, views_t)  # noqa: E731
        k5_kernel = lambda: ff._field_backward_flat(ws, meta, pts_t, views_t, g_raw)  # noqa: E731
        t = dict(
            k4=time_ms(k4_step, 10),
            k4_kernel=time_ms(k4_kernel, 10),
            k4_plain=time_ms(lambda: ff.field_forward_plain(inputs, meta, pts_t, views_t), 3),
            k5=time_ms(k5_step, 5),
            k5_kernel=time_ms(k5_kernel, 5),
            k5_plain=time_ms(lambda: ff.field_backward_plain(inputs, meta, pts_t, views_t, g_raw), 3),
            pack=time_ms(lambda: ff._pack_leaves(trainer.params[net], leaves_net, net_spec, meta), 10),
            k4_matmul=field_products_matmul_ms(inputs, n, backward=False),
            k5_matmul=field_products_matmul_ms(inputs, n, backward=True),
        )
        if net == "proposal" or graph:
            t.update(k4_graph=graph_ms(k4_step, 20), k5_graph=graph_ms(k5_step, 20),
                     k4_kernel_graph=graph_ms(k4_kernel, 20), k5_kernel_graph=graph_ms(k5_kernel, 20))
        # Bytes: points and view directions in, raw [8, N] out, the fp32
        # leaves read once (the pack); the backward reads cotangent rows 0-3,
        # the bf16 weights and their transposes, and writes fp32 gradients.
        w_bytes = sum(x.numel() * 2 for x in leaves[net])
        b4 = bound_ms(2 * mac_fwd * n, n * (6 * 4 + 8 * 4) + 2 * w_bytes)
        b5 = bound_ms(2 * mac_bwd * n, n * (6 * 4 + 4 * 4) + 4 * w_bytes)
        # K5's design also writes its bf16 scratch and reads it back.
        n_scratch = ff._backward_sizes(meta, n)[0]
        b5_design = 2 * n_scratch * 2 / PEAK_BYTES * 1e3
        res[net] = dict(n=n, k4_err=k4_err, k5_rel=worst[0], k5_abs=max(e[1] for e in errs), worst=worst[2],
                        t=t, b4=b4, b5=b5, b5_design=b5_design, library=_build.field_library(*ff._shape(meta)))
        graphs = (f"; as one CUDA graph of 20: K4 {t['k4_graph']:.4f} (kernel {t['k4_kernel_graph']:.4f}), "
                  f"K5 {t['k5_graph']:.4f} (kernels {t['k5_kernel_graph']:.4f})") if "k4_graph" in t else ""
        print(f"{label}{net} field ({res[net]['library']}), {n} points: K4 ms {t['k4']:.3f} (pack + kernel; kernel "
              f"{t['k4_kernel']:.3f}, pack {t['pack']:.4f}) plain_ms {t['k4_plain']:.3f} bound_ms {b4[0]:.4f} "
              f"({b4[1]}) max_abs_err {k4_err:.2e} (vs fp32), products as torch.matmul {t['k4_matmul']:.3f}; "
              f"K5 ms {t['k5']:.3f} (kernels + gradient gather; kernels {t['k5_kernel']:.3f}) plain_ms "
              f"{t['k5_plain']:.3f} bound_ms {b5[0]:.4f} ({b5[1]}; design bytes bound {b5_design:.4f}) max rel "
              f"err {worst[0]:.2e} ({worst[2]}), deterministic {same}, products as torch.matmul "
              f"{t['k5_matmul']:.3f}{graphs}", flush=True)
    return res


def train_phase(card: str, device: torch.device):
    """The training path (module docstring); returns the K4 and K5 entries
    of the kernels line, at the stock shape and at the proposal shape."""
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_room_scene_splits
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import settings_from_config, spec_from_config
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import device_kernel_counts
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    cfg = train_config()
    spec = spec_from_config(cfg)
    prop_spec = proposal_spec(6)
    w, h = TRAIN_SIZE
    near, far = cfg.rendering.depth_range
    t0 = time.time()
    train, test, _ = make_room_scene_splits(n_frames=TRAIN_FRAMES, stride=TRAIN_STRIDE, height=h, width=w,
                                            near=near, far=far, device=device)
    print(f"room scene: {len(train)} train / {len(test)} test views at {w}x{h}, ground truth "
          f"{time.time() - t0:.1f} s", flush=True)
    out_dir = os.path.join(HERE, "build", "torch_kernels", "smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)

    def trainer(field_impl: str, name: str, steps_per_call: int = 1, **kw) -> Trainer:
        tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, device=device,
                     save_dir=os.path.join(out_dir, name), enable_tensorboard=False,
                     field_impl=field_impl, eval_max_views=TRAIN_EVAL_VIEWS, steps_per_call=steps_per_call, **kw)
        tr.setup()
        return tr

    fused = trainer("auto", "fused")
    require(fused.field_impl == "fused", f"field_impl auto on {device} chose {fused.field_impl}")

    # 2. K4 and K5 against the fp32 plain field on one real step's points.
    settings = settings_from_config(cfg)._replace(train=True, field_impl="plain")
    specs = {"coarse": spec, "fine": spec, "proposal": prop_spec}
    res = field_leg(device, fused, ("coarse", "fine"), specs, settings, spec, cfg)

    # 3. Train with the fused field: exactly two K4 and two K5 calls per step.
    def run(tr: Trainer, ckpt_at: int = -1, steps: int = TRAIN_STEPS, label: str = ""):
        losses, ms, ckpt = [], [], None
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(tr.step(i)["total_loss"]))  # waits for the step's device work
            ms.append((time.perf_counter() - t0) * 1e3)
            if i + 1 == ckpt_at:
                ckpt = tr.save_models_checkpoint(ckpt_at)
        k = TRAIN_WINDOW
        name = label or tr.field_impl
        require(all(np.isfinite(losses)), f"{name}: non-finite loss")
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        require(last < first, f"{name}: loss did not fall ({first} -> {last})")
        warm = float(np.median(ms[WARM_SKIP:]))
        print(f"train {name}: {steps} steps, mean loss first {k} {first:.5f} -> last {k} "
              f"{last:.5f}; warm ms/step {warm:.2f} (median), {1e3 / warm:.1f} steps/s; first step "
              f"{ms[0]:.1f} ms; card {card}", flush=True)
        return losses, warm, ckpt

    counters = (ff.LAUNCHES, fr.LAUNCHES, im.LAUNCHES, *ff.SHAPE_LAUNCHES.values())
    zero_launches(*counters)
    losses, warm_fused, ckpt = run(fused, RESUME_STEP)
    launches = dict(ff.LAUNCHES)
    want = {"forward": 2 * TRAIN_STEPS, "backward": 2 * TRAIN_STEPS,
            "backward_kernels": 2 * ff.BACKWARD_KERNELS * TRAIN_STEPS}
    require(launches == want, f"K4/K5 launches {launches}, expected {want}")
    require(sum(fr.LAUNCHES.values()) + sum(im.LAUNCHES.values()) == 0, "a render kernel ran in a train step")
    print(f"train launches: K4 {launches['forward']}, K5 {launches['backward']} calls "
          f"({launches['backward_kernels']} kernel launches): {launches['forward'] / TRAIN_STEPS:g} and "
          f"{launches['backward'] / TRAIN_STEPS:g} per step", flush=True)
    zero_launches(*counters)
    psnr_fused = fused.render_test_images(TRAIN_STEPS)
    eval_launches = {"K1": fr.LAUNCHES["density_only"], "K2": im.LAUNCHES["importance_merge"],
                     "K3": fr.LAUNCHES["full"]}
    require(min(eval_launches.values()) >= 1 and sum(ff.LAUNCHES.values()) == 0,
            f"eval render launches {eval_launches}, field {ff.LAUNCHES}")
    print(f"test views ({TRAIN_EVAL_VIEWS}) through K1-K3: PSNR {psnr_fused:.3f} dB; launches {eval_launches}",
          flush=True)

    # 4. The same steps with the plain fp32 field.
    plain = trainer("plain", "plain")
    zero_launches(*counters)
    _, warm_plain, _ = run(plain)
    require(sum(ff.LAUNCHES.values()) == 0, f"the plain field launched {ff.LAUNCHES}")
    psnr_plain = plain.render_test_images(TRAIN_STEPS)
    gap = abs(psnr_fused - psnr_plain)
    print(f"test-view PSNR after {TRAIN_STEPS} steps: fused {psnr_fused:.3f} dB, plain {psnr_plain:.3f} dB "
          f"(gap {gap:.3f}, limit {PSNR_GAP_DB}); warm ms/step fused {warm_fused:.2f}, plain {warm_plain:.2f}",
          flush=True)
    require(np.isfinite(gap) and gap <= PSNR_GAP_DB, f"PSNR gap {gap} dB")
    del plain

    # 5. Resume a fresh Trainer from the step-RESUME_STEP checkpoint: its next
    # two losses (params, then params after an Adam update from the restored
    # moments) equal the uninterrupted run's.
    resumed = trainer("auto", "resumed")
    start = resumed.resume_from_checkpoint(ckpt)
    require(start == RESUME_STEP, f"resumed at {start}")
    again = [float(resumed.step(i)["total_loss"]) for i in (start, start + 1)]
    diffs = [abs(a - b) for a, b in zip(again, losses[start: start + 2])]
    print(f"resume from step {start}: losses {again[0]:.7f}, {again[1]:.7f} against {losses[start]:.7f}, "
          f"{losses[start + 1]:.7f} (|diff| {diffs[0]:.1e}, {diffs[1]:.1e})", flush=True)
    require(max(diffs) <= 1e-6, f"resumed losses differ by {diffs}")
    del resumed

    # 6. The same steps at steps_per_call=GRAPH_K: the first call runs its
    # steps eagerly and captures a CUDA graph of GRAPH_K steps, every later
    # call replays it. A replay calls no wrapper, so the K4/K5 kernels it
    # ran are counted from a profiler trace of the last calls.
    def graph_leg(graphed: Trainer, eager_losses, eager_ms: float, label: str):
        g_losses, call_ms = [], []
        n_calls = TRAIN_STEPS // GRAPH_K

        def graph_calls(calls):
            for c in calls:
                t0 = time.perf_counter()
                m = graphed.step_many(c * GRAPH_K)
                g_losses.extend(m["total_loss_steps"].tolist())  # waits for the call's device work
                call_ms.append((time.perf_counter() - t0) * 1e3)

        timed = n_calls - GRAPH_PROFILED_CALLS
        graph_calls(range(timed))
        require(graphed.graph_captured, f"{label}: no CUDA graph was captured")
        wrapped = dict(ff.LAUNCHES)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            graph_calls(range(timed, n_calls))
        require(ff.LAUNCHES == wrapped, f"a replay moved the K4/K5 wrappers' counts: {wrapped} -> {ff.LAUNCHES}")
        ran = device_kernel_counts(prof)
        g_steps = GRAPH_PROFILED_CALLS * GRAPH_K
        g_launches = {key: sum(ran.get(k, 0) for k in names) for key, names in TRAIN_KERNELS.items()}
        g_want = {key: v * g_steps // TRAIN_STEPS for key, v in want.items()}
        require(g_launches == g_want, f"{label} graph replays ran K4/K5 kernels {g_launches}, expected {g_want}")
        g_diff = max(abs(a - b) for a, b in zip(g_losses, eager_losses))
        warm_graph = float(np.median(call_ms[1:timed])) / GRAPH_K
        print(f"{label}: {TRAIN_STEPS} steps at steps_per_call={GRAPH_K} ({n_calls} calls, the first "
              f"capturing, {call_ms[0]:.1f} ms): losses against the eager run max |diff| {g_diff:.1e} (limit "
              f"1e-6); warm ms/step graph {warm_graph:.2f} (median of calls 2..{timed} / {GRAPH_K}), eager "
              f"{eager_ms:.2f}; kernels run by the last {GRAPH_PROFILED_CALLS} replays ({g_steps} steps, "
              f"profiler trace) {g_launches}; card {card}", flush=True)
        require(g_diff <= 1e-6, f"{label}: graph-replayed losses differ from the eager run's by {g_diff}")
        return warm_graph, g_launches, g_steps

    warm_graph, g_launches, g_steps = graph_leg(trainer("auto", "graphed", steps_per_call=GRAPH_K), losses,
                                                warm_fused, "train graph")

    # 7. Proposal training: the stock config with the 2x64 proposal net in
    # the coarse net's place. Its K4/K5 against the plain field on one real
    # step's proposal points; 300 fused steps (one K4 and one K5 call a
    # step through each of the two libraries), their test views against 300
    # plain steps', the graph leg, 300 --fast-preset steps; the checkpoint
    # served at the fast preset against its parity frame.
    prop = trainer("auto", "proposal", use_proposal=True)
    p_settings = settings._replace(use_proposal=True)
    res.update(field_leg(device, prop, ("proposal",), specs, p_settings, spec, cfg))
    c_lib, p_lib = res["fine"]["library"], res["proposal"]["library"]
    zero_launches(*counters)
    p_losses, p_warm, p_ckpt = run(prop, TRAIN_STEPS, label="proposal fused")
    p_launches = {lib: dict(v) for lib, v in ff.SHAPE_LAUNCHES.items() if sum(v.values())}
    p_want = {lib: {"forward": TRAIN_STEPS, "backward": TRAIN_STEPS} for lib in (c_lib, p_lib)}
    require(p_launches == p_want and launches_equal(ff.LAUNCHES, want),
            f"proposal K4/K5 launches {p_launches} ({ff.LAUNCHES}), expected {p_want}")
    print(f"train proposal launches by library: {p_launches}", flush=True)
    p_psnr = prop.render_test_images(TRAIN_STEPS)
    p_plain = trainer("plain", "proposal_plain", use_proposal=True)
    zero_launches(*counters)
    _, p_warm_plain, _ = run(p_plain, label="proposal plain")
    require(sum(ff.LAUNCHES.values()) == 0, f"the plain proposal field launched {ff.LAUNCHES}")
    p_psnr_plain = p_plain.render_test_images(TRAIN_STEPS)
    p_gap = abs(p_psnr - p_psnr_plain)
    print(f"train proposal: test-view PSNR after {TRAIN_STEPS} steps fused {p_psnr:.3f} dB, plain "
          f"{p_psnr_plain:.3f} dB (gap {p_gap:.3f}, limit {PSNR_GAP_DB}); warm ms/step fused {p_warm:.2f}, plain "
          f"{p_warm_plain:.2f}", flush=True)
    require(np.isfinite(p_gap) and p_gap <= PSNR_GAP_DB, f"proposal PSNR gap {p_gap} dB")
    del p_plain
    p_warm_graph, p_g_launches, _ = graph_leg(trainer("auto", "proposal_graphed", GRAPH_K, use_proposal=True),
                                              p_losses, p_warm, "train proposal graph")
    fast = trainer("auto", "proposal_fast", use_proposal=True, merge_coarse=False)
    zero_launches(*counters)
    _, f_warm, _ = run(fast, label="proposal fast-preset fused")
    require(launches_equal(ff.LAUNCHES, want), f"fast-preset K4/K5 launches {ff.LAUNCHES}, expected {want}")
    f_psnr = fast.render_test_images(TRAIN_STEPS)
    print(f"train proposal fast-preset: test-view PSNR {f_psnr:.3f} dB after {TRAIN_STEPS} steps", flush=True)
    del fast
    serve = serve_proposal_checkpoint(card, device, cfg, p_ckpt, test.camera_pose[0])
    shutil.rmtree(out_dir, ignore_errors=True)

    src = f"{PACKAGE}/csrc/train_field.cu"
    c, f, p = res["coarse"], res["fine"], res["proposal"]
    per_step = lambda key: c["t"][key] + f["t"][key]  # noqa: E731
    common = dict(route="cuda", source=src, library_ms=None, held_against_plain=True, calls_per_step=2,
                  points_coarse=c["n"], points_fine=f["n"], step_ms_eager=warm_fused, step_ms_graph=warm_graph,
                  graph_profiled_steps=g_steps, pack_ms=per_step("pack"), library=c["library"])
    p_common = dict(route="cuda", source=src, library_ms=None, held_against_plain=True, calls_per_step=1,
                    points=p["n"], step_ms_eager=p_warm, step_ms_graph=p_warm_graph, step_ms_plain=p_warm_plain,
                    step_ms_fast_preset=f_warm, psnr_fused=p_psnr, psnr_plain=p_psnr_plain, pack_ms=p["t"]["pack"],
                    library=p["library"], served_fast_preset=serve)
    return [
        dict(name="K4 fused field forward (training, coarse + fine call of one step)",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_train.py:222", launches=launches["forward"],
             max_abs_err=max(c["k4_err"], f["k4_err"]), ms=per_step("k4"), kernel_ms=per_step("k4_kernel"),
             plain_ms=per_step("k4_plain"), bound_ms=c["b4"][0] + f["b4"][0], bound_by=f["b4"][1],
             graph_launches=g_launches["forward"], ms_coarse=c["t"]["k4"],
             ms_fine=f["t"]["k4"], products_matmul_ms=per_step("k4_matmul"), **common),
        dict(name="K5 fused field backward (training, coarse + fine call of one step)",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_train.py:237", launches=launches["backward"],
             kernel_launches=launches["backward_kernels"], max_abs_err=max(c["k5_abs"], f["k5_abs"]),
             max_rel_err=max(c["k5_rel"], f["k5_rel"]), deterministic=True, ms=per_step("k5"),
             kernel_ms=per_step("k5_kernel"), plain_ms=per_step("k5_plain"), graph_launches=g_launches["backward"],
             graph_kernel_launches=g_launches["backward_kernels"], bound_ms=c["b5"][0] + f["b5"][0], bound_by=f["b5"][1],
             design_bytes_bound_ms=c["b5_design"] + f["b5_design"], ms_coarse=c["t"]["k5"], ms_fine=f["t"]["k5"],
             products_matmul_ms=per_step("k5_matmul"), **common),
        dict(name="K4 fused field forward (training, proposal 2x64@6f/2f call of one step)",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_train.py:222",
             launches=p_launches[p["library"]]["forward"], max_abs_err=p["k4_err"], ms=p["t"]["k4"],
             kernel_ms=p["t"]["k4_kernel"], graph_ms=p["t"]["k4_graph"], kernel_graph_ms=p["t"]["k4_kernel_graph"],
             plain_ms=p["t"]["k4_plain"], bound_ms=p["b4"][0], bound_by=p["b4"][1],
             products_matmul_ms=p["t"]["k4_matmul"], **p_common),
        dict(name="K5 fused field backward (training, proposal 2x64@6f/2f call of one step)",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_train.py:237",
             launches=p_launches[p["library"]]["backward"], max_abs_err=p["k5_abs"], max_rel_err=p["k5_rel"],
             deterministic=True, ms=p["t"]["k5"], kernel_ms=p["t"]["k5_kernel"], graph_ms=p["t"]["k5_graph"],
             kernel_graph_ms=p["t"]["k5_kernel_graph"], plain_ms=p["t"]["k5_plain"], bound_ms=p["b5"][0],
             bound_by=p["b5"][1], design_bytes_bound_ms=p["b5_design"], products_matmul_ms=p["t"]["k5_matmul"],
             **p_common),
    ]


DISTILL_SIZE = (128, 96)  # width, height of the room distillation recipe's views (scripts/make_bench_fixture.py)
DISTILL_STEPS = 500  # of the recipe's 50,000 (train/distill.py DEFAULT_DISTILL_STEPS)
DISTILL_GRAPH_STEPS = 100  # the student's steps as CUDA-graph replays, against the eager run's
SPEED_STEPS = 300  # the opt-in 4x128@8f student's run (cli/distill.py --depth 4 --width 128 --freqs 8)
DISTILL_STUDENT = (6, 192, 10)  # depth, width, point frequencies: train/distill.py DEFAULT_STUDENT
SPEED_STUDENT = (4, 128, 8)  # train/distill.py SPEED_STUDENT


def distill_phase(card: str, device: torch.device):
    """Distillation (module docstring); returns the kernels line's entries
    of K4/K5 at the two student shapes."""
    from nerf_workspaces_explorer_tpu_torch.core.config import ExperimentConfig, FrameworkConfig, RenderingConfig
    from nerf_workspaces_explorer_tpu_torch.core.types import COORD
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.data.replica import SceneData
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import (
        room_coverage_poses,
        room_grid_poses,
        room_scene,
        walkthrough_poses,
    )
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer, settings_from_config, spec_from_config
    from nerf_workspaces_explorer_tpu_torch.ops import _build
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.train import distill as dist
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim

    t_phase = time.time()
    w, h = DISTILL_SIZE
    teacher, _, meta = load_checkpoint(ROOM_CKPT)
    near, far = (float(x) for x in meta["depth_range"])
    cfg = FrameworkConfig(experiment=ExperimentConfig(image_width=w, image_height=h),
                          rendering=RenderingConfig(depth_range=(near, far)))
    teacher_settings = settings_from_config(cfg).for_eval()._replace(use_proposal=True)
    # The recipe's views: the walkthrough's train poses (make_room_scene_splits
    # at its defaults: 900 frames, every 5th), the off-tour coverage views,
    # then the probe grid, held out.
    half = np.asarray(room_scene().half)
    grid = room_grid_poses(half=half)
    poses = np.concatenate([walkthrough_poses(900, half=half)[::5], room_coverage_poses(half), grid])
    n_views, n_holdout = len(poses), len(grid)
    out_dir = os.path.join(HERE, "build", "torch_kernels", "smoke_distill")
    shutil.rmtree(out_dir, ignore_errors=True)
    counters = (ff.LAUNCHES, fr.LAUNCHES, im.LAUNCHES, *ff.SHAPE_LAUNCHES.values())
    libs = {s: _build.field_library(s[1], s[2], 4) for s in (DISTILL_STUDENT, SPEED_STUDENT)}
    prop_lib = _build.field_library(64, 6, 2)

    # 1. The teacher's views through the fused path: K1, K2, K3 once a view.
    zero_launches(*counters)
    t0 = time.perf_counter()
    rgb = dist.render_teacher_views(teacher, spec_from_config(cfg), teacher_settings, poses, h, w, near=near,
                                    far=far, device=device)
    teacher_ms = (time.perf_counter() - t0) * 1e3 / n_views
    t_launches = {"K1": fr.LAUNCHES["density_only"], "K2": im.LAUNCHES["importance_merge"], "K3": fr.LAUNCHES["full"]}
    require(t_launches == {"K1": n_views, "K2": n_views, "K3": n_views} and sum(ff.LAUNCHES.values()) == 0,
            f"teacher views launched {t_launches}, field {ff.LAUNCHES}")
    require(rgb.shape == (n_views, h, w, 3) and bool(np.isfinite(rgb).all()) and rgb.std() > 0.01,
            f"teacher views {rgb.shape}, std {rgb.std()}")
    print(f"distill teacher views: {n_views} at {w}x{h} (room_proposal.npz, 2x64@6f proposal + 8x256 fine) through "
          f"K1-K3, {teacher_ms:.3f} ms a view (host clock, the copy to the host included); launches {t_launches}; "
          f"mean level {rgb.mean():.4f}; card {card}", flush=True)

    # 2. K4/K5 at each student's shape against the fp32 plain field on one
    # real distillation step's points (the student's and proposal nets'
    # initial weights, step 0's draws on the teacher's views).
    n_train = n_views - n_holdout
    zeros = np.zeros(rgb.shape[:3], np.float32)
    train_data = SceneData(rgb[:n_train], zeros[:n_train], poses[:n_train])
    test_data = SceneData(rgb[n_train:], zeros[n_train:], poses[n_train:])
    res = {}
    for student in (DISTILL_STUDENT, SPEED_STUDENT):
        depth, width, freqs = student
        s_cfg = dist.student_config(h, w, near=near, far=far, depth=depth, net_width=width, num_freqs_3d=freqs)
        tr = Trainer(f"leg_{width}", s_cfg, train_data=train_data, test_data=test_data, device=device,
                     save_dir=os.path.join(out_dir, f"leg_{width}"), enable_tensorboard=False, use_proposal=True)
        tr.setup()
        s_settings = settings_from_config(s_cfg)._replace(train=True, field_impl="plain", use_proposal=True)
        res[student] = field_leg(device, tr, ("fine",), {"fine": tr._spec}, s_settings, tr._spec, s_cfg,
                                 graph=True, label=f"distill student {depth}x{width}@{freqs}f ")["fine"]
        del tr
    for student, lib in libs.items():
        bad = library_spills(lib)
        counts = sass_counts(lib)
        lines = [ln.strip() for ln in _build.build_log(lib).splitlines()
                 if ("Used" in ln and "registers" in ln) or "stack frame" in ln]
        print(f"distill ptxas {lib}: {' | '.join(lines)}; spills {bad or 'none'}; sass {counts}", flush=True)
        require(not bad, f"{lib}: ptxas spills {bad}")
        require(counts is None or (counts["HMMA"] == 0 and counts["IMMA"] == 0 and counts["HGMMA"] > 0),
                f"{lib}: the products must be wgmma alone {counts}")

    # 3. distill_student with the fused field (the student's and the
    # proposal net's libraries, one K4 and one K5 call a step each), then
    # with the plain fp32 field, on the same teacher views; the opt-in
    # speed student's shorter run.
    def distill(student, steps, field_impl, name):
        depth, width, freqs = student
        losses, rgb_losses, stamps = [], [], []

        def on_step(i, metrics):
            losses.append(float(metrics["total_loss"]))  # waits for the step's device work
            rgb_losses.append(float(metrics["rgb_loss_fine"]))
            stamps.append(time.perf_counter())

        zero_launches(*counters)
        params, s_cfg, report = dist.distill_student(
            teacher, spec_from_config(cfg), teacher_settings, poses, height=h, width=w, near=near, far=far,
            steps=steps, depth=depth, net_width=width, num_freqs_3d=freqs, n_holdout=n_holdout, log_every=0,
            name=name, teacher_rgb=rgb, field_impl=field_impl, save_dir=os.path.join(out_dir, name), device=device,
            on_step=on_step)
        k = TRAIN_WINDOW
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        rgb_first, rgb_last = float(np.mean(rgb_losses[:k])), float(np.mean(rgb_losses[-k:]))
        warm = float(np.median(np.diff(stamps)[WARM_SKIP:])) * 1e3
        launches = {lib: dict(v) for lib, v in ff.SHAPE_LAUNCHES.items() if sum(v.values())}
        held = {"K1": fr.LAUNCHES["density_only"], "K6": im.LAUNCHES["importance_only"], "K3": fr.LAUNCHES["full"]}
        # The photometric term is what distillation fits; the total adds the
        # interlevel term, which starts near zero while neither net holds
        # density and grows as the fine net forms surfaces.
        require(all(np.isfinite(losses)) and rgb_last < rgb_first, f"{name}: rgb loss {rgb_first} -> {rgb_last}")
        require(np.isfinite(report["psnr_vs_teacher"]), f"{name}: report {report}")
        require(held == {"K1": n_holdout, "K6": n_holdout, "K3": n_holdout}, f"{name}: held-out views {held}")
        print(f"distill {name} ({depth}x{width}@{freqs}f, field {field_impl}): {steps} steps, mean loss first {k} "
              f"{first:.5f} -> last {k} {last:.5f} (fine rgb loss {rgb_first:.5f} -> {rgb_last:.5f}); warm ms/step {warm:.2f} (median); K4/K5 calls by library "
              f"{launches}; psnr_vs_teacher {report['psnr_vs_teacher']:.3f} dB (min "
              f"{report['psnr_vs_teacher_min']:.3f}) on the {n_holdout} held-out views through K1/K6/K3; card {card}",
              flush=True)
        return params, s_cfg, report, warm, launches, losses

    params, s_cfg, report, warm, d_launches, d_losses = distill(DISTILL_STUDENT, DISTILL_STEPS, "auto",
                                                                "student_fused")
    lib = libs[DISTILL_STUDENT]
    d_want = {lib: {"forward": DISTILL_STEPS, "backward": DISTILL_STEPS},
              prop_lib: {"forward": DISTILL_STEPS, "backward": DISTILL_STEPS}}
    require(d_launches == d_want, f"distillation K4/K5 launches {d_launches}, expected {d_want}")
    _, _, p_report, p_warm, p_launches, _ = distill(DISTILL_STUDENT, DISTILL_STEPS, "plain", "student_plain")
    require(not p_launches, f"the plain student field launched {p_launches}")
    gap = abs(report["psnr_vs_teacher"] - p_report["psnr_vs_teacher"])
    print(f"distill student: psnr_vs_teacher fused {report['psnr_vs_teacher']:.3f} dB, plain "
          f"{p_report['psnr_vs_teacher']:.3f} dB (gap {gap:.3f}, limit {PSNR_GAP_DB}); warm ms/step fused "
          f"{warm:.2f}, plain {p_warm:.2f}", flush=True)
    require(gap <= PSNR_GAP_DB, f"distillation PSNR gap {gap} dB")
    # The same student steps as replays of a CUDA graph of GRAPH_K steps
    # (a measurement: distill_student steps eagerly): a Trainer of the
    # student's config, seed and views takes the fused run's trajectory.
    graphed = Trainer("graphed", s_cfg, train_data=train_data, test_data=test_data, device=device,
                      save_dir=os.path.join(out_dir, "graphed"), enable_tensorboard=False, use_proposal=True,
                      steps_per_call=GRAPH_K)
    graphed.setup()
    g_losses, call_ms = [], []
    for c in range(DISTILL_GRAPH_STEPS // GRAPH_K):
        t0 = time.perf_counter()
        g_losses += graphed.step_many(c * GRAPH_K)["total_loss_steps"].tolist()  # waits for the call
        call_ms.append((time.perf_counter() - t0) * 1e3)
    g_diff = max(abs(a - b) for a, b in zip(g_losses, d_losses))
    g_warm = float(np.median(call_ms[1:])) / GRAPH_K
    print(f"distill student graph: {DISTILL_GRAPH_STEPS} steps at steps_per_call={GRAPH_K} (the first call "
          f"capturing, {call_ms[0]:.1f} ms): losses against the eager run max |diff| {g_diff:.1e} (limit 1e-6); "
          f"warm ms/step graph {g_warm:.2f}, eager {warm:.2f}; card {card}", flush=True)
    require(graphed.graph_captured and g_diff <= 1e-6, f"distillation graph leg: losses differ by {g_diff}")
    del graphed
    _, _, sp_report, sp_warm, sp_launches, _ = distill(SPEED_STUDENT, SPEED_STEPS, "auto", "speed_fused")
    sp_want = {libs[SPEED_STUDENT]: {"forward": SPEED_STEPS, "backward": SPEED_STEPS},
               prop_lib: {"forward": SPEED_STEPS, "backward": SPEED_STEPS}}
    require(sp_launches == sp_want, f"speed student K4/K5 launches {sp_launches}, expected {sp_want}")

    # 4. The sidecar: written beside a teacher path, its metadata read back
    # equal to what was written, served at the turbo preset (bf16) at
    # 320x240 on the room's spot.
    ckpt = os.path.join(out_dir, os.path.basename(ROOM_CKPT))
    sidecar = dist.turbo_sidecar_path(ckpt)
    dist.save_turbo_checkpoint(sidecar, params, s_cfg, report=report, teacher=ROOM_CKPT, step=DISTILL_STEPS)
    served_at = {"n_importance": 48, "proposal_subsample": 4}
    want_meta = {
        "turbo": True, "teacher": os.path.basename(ROOM_CKPT),
        "student": {"depth": 6, "width": 192, "num_freqs_3d": 10, "num_freqs_2d": 4, "n_samples": 64,
                    "n_importance": 48, "proposal_num_freqs": 6, "proposal_subsample": 4},
        "distill_report": dict(report, measured_at=served_at), "step": DISTILL_STEPS,
    }
    got_meta = dist.read_turbo_metadata(sidecar)
    require(got_meta == want_meta, f"sidecar metadata {got_meta}")
    tokyo = train_config()
    room_cfg = dataclasses.replace(tokyo, rendering=dataclasses.replace(tokyo.rendering, depth_range=(near, far)))
    room_init = COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0)
    room_poses = [poses_from_coordinates(room_init, [COORD(yaw=y)])[0] for y in ROOM_YAWS]

    def turbo(precision, **kw):
        r = NeRFRenderer("tokyo", ckpt, config=room_cfg, precision=precision, preset="turbo", device=device, **kw)
        r.initialize_models()
        return r

    served, exact, parity = turbo("fast"), turbo("fast", proposal_subsample=1), turbo("parity")
    for pose in room_poses:  # the first frame eager, then the frame graph's capture; replays
        served.render_pose_uint8(pose).cpu()
    zero_launches(*counters)
    serve_ms = []
    for _ in range(SERVE_REPS):
        for pose in room_poses:
            t0 = time.perf_counter()
            frame = served.render_pose_uint8(pose).cpu().numpy()  # ends in a device -> host copy
            serve_ms.append((time.perf_counter() - t0) * 1e3)
    n_frames = SERVE_REPS * len(room_poses)
    require(sum(fr.LAUNCHES.values()) + sum(im.LAUNCHES.values()) == 0,
            f"the sidecar's replayed frames called the render wrappers: {fr.LAUNCHES}, {im.LAUNCHES}")
    ran = traced_render_passes(lambda: [served.render_pose_uint8(p).cpu() for p in room_poses])
    s_launches = {"K1": ran["density_only"], "K6": ran["placement"], "K3": ran["full"]}
    require(s_launches == {k: len(room_poses) for k in s_launches},
            f"sidecar serve: {len(room_poses)} replayed frames ran {s_launches}")
    scores, scores_served = [], []
    for pose in room_poses:
        a = exact.render_pose_uint8(pose).cpu().numpy()
        b = parity.render_pose_uint8(pose).cpu().numpy()
        c = served.render_pose_uint8(pose).cpu().numpy()
        require(a.shape == (tokyo.experiment.image_height, tokyo.experiment.image_width, 3), f"frame {a.shape}")
        scores.append(ssim(a / 255.0, b / 255.0))
        scores_served.append(ssim(c / 255.0, a / 255.0))
    print(f"distill sidecar {os.path.basename(sidecar)}: metadata read back equal; served at turbo (bf16, stride 4) "
          f"{frame.shape[1]}x{frame.shape[0]}: warm ms/frame {float(np.median(serve_ms)):.2f} (median of "
          f"{n_frames}); kernels run by {len(room_poses)} replayed frames (profiler trace) {s_launches}; SSIM vs "
          f"parity at stride 1 "
          f"{', '.join(f'{x:.5f}' for x in scores)} (gate {SSIM_GATE}); stride 4 vs stride 1 "
          f"{', '.join(f'{x:.5f}' for x in scores_served)}; mean level {frame.mean():.2f}; card {card}", flush=True)
    require(min(scores) >= SSIM_GATE, f"distilled sidecar at turbo: SSIM {scores} against parity")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"distill phase: {time.time() - t_phase:.1f} s", flush=True)

    src = f"{PACKAGE}/csrc/train_field.cu"
    entries = []
    for student, runs in ((DISTILL_STUDENT, d_launches), (SPEED_STUDENT, sp_launches)):
        r, lib = res[student], libs[student]
        t = r["t"]
        tag = "{}x{}@{}f".format(*student)
        common = dict(route="cuda", source=src, library_ms=None, held_against_plain=True, calls_per_step=1,
                      points=r["n"], library=lib, pack_ms=t["pack"])
        if student == DISTILL_STUDENT:
            common.update(step_ms_eager=warm, step_ms_graph=g_warm, step_ms_plain=p_warm,
                          psnr_vs_teacher_fused=report["psnr_vs_teacher"],
                          psnr_vs_teacher_plain=p_report["psnr_vs_teacher"], distill_steps=DISTILL_STEPS)
        else:
            common.update(step_ms_eager=sp_warm, psnr_vs_teacher_fused=sp_report["psnr_vs_teacher"],
                          distill_steps=SPEED_STEPS)
        entries += [
            dict(name=f"K4 fused field forward (distillation, student {tag} call of one step)",
                 replaces="nerf_workspaces_explorer_tpu/ops/pallas_train.py:222", launches=runs[lib]["forward"],
                 max_abs_err=r["k4_err"], ms=t["k4"], kernel_ms=t["k4_kernel"], graph_ms=t["k4_graph"],
                 kernel_graph_ms=t["k4_kernel_graph"], plain_ms=t["k4_plain"], bound_ms=r["b4"][0],
                 bound_by=r["b4"][1], products_matmul_ms=t["k4_matmul"], **common),
            dict(name=f"K5 fused field backward (distillation, student {tag} call of one step)",
                 replaces="nerf_workspaces_explorer_tpu/ops/pallas_train.py:237", launches=runs[lib]["backward"],
                 max_abs_err=r["k5_abs"], max_rel_err=r["k5_rel"], deterministic=True, ms=t["k5"],
                 kernel_ms=t["k5_kernel"], graph_ms=t["k5_graph"], kernel_graph_ms=t["k5_kernel_graph"],
                 plain_ms=t["k5_plain"], bound_ms=r["b5"][0], bound_by=r["b5"][1],
                 design_bytes_bound_ms=r["b5_design"], products_matmul_ms=t["k5_matmul"], **common),
        ]
    return entries


def launches_equal(got: dict, want: dict) -> bool:
    return {k: got[k] for k in want} == want


def serve_proposal_checkpoint(card: str, device: torch.device, cfg, ckpt: str, pose) -> dict:
    """The proposal run's checkpoint served for one 320x240 frame of a room
    test view at the fast preset (bf16, importance-only placement) at stride
    1 against its fp32 parity frame (SSIM >= SSIM_GATE), and at the preset's
    served stride 4 (SSIM to stride 1 printed)."""
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim

    def frame(precision, **kw):
        r = NeRFRenderer("tokyo", ckpt, config=cfg, precision=precision, preset="fast", use_proposal=True,
                         device=device, **kw)
        r.initialize_models()
        return r.render_pose_uint8(pose).cpu().numpy()

    zero_launches(fr.LAUNCHES, im.LAUNCHES)
    exact = frame("fast", proposal_subsample=1)
    served = frame("fast")
    launches = {k: v for d in (fr.LAUNCHES, im.LAUNCHES) for k, v in d.items() if v}
    parity = frame("parity")
    score, score_served = ssim(exact / 255.0, parity / 255.0), ssim(served / 255.0, exact / 255.0)
    print(f"serve proposal checkpoint (fast preset, bf16, room test view 0, {exact.shape[1]}x{exact.shape[0]}): "
          f"SSIM vs parity at stride 1 {score:.5f} (gate {SSIM_GATE}); stride 4 vs stride 1 {score_served:.5f}; "
          f"launches {launches}; mean level {exact.mean():.2f}; card {card}", flush=True)
    require(exact.shape == (TRAIN_SIZE[1], TRAIN_SIZE[0], 3) and score >= SSIM_GATE,
            f"proposal checkpoint at the fast preset: SSIM {score} against parity")
    # Each renderer's one frame: eager, then the frame graph's capture.
    require(launches == {"density_only": 4, "importance_only": 4, "full": 4}, f"serve launches {launches}")
    return dict(ssim_vs_parity_stride1=score, ssim_stride4_vs_stride1=score_served)


ROOM_CKPT = os.path.join(HERE, "assets", "bench", "room_proposal.npz")
ROOM_YAWS = (-30.0, 0.0, 30.0)  # three walkthrough views from bench.py's room spot
SERVE_REPS = 2  # passes over a row's three poses: 6 warm frames per median
STRIDE = 4  # the served placement stride of the proposal rows


def k7_share_exact(out, ref, rows):
    """Share of rays whose outputs agree to 1e-6."""
    return float(((out[rows] - ref[rows]).abs().amax(0) <= 1e-6).float().mean())


def presets_phase(card: str, device: torch.device, main: dict):
    """The serving presets and precisions (module docstring); returns the
    kernels line's entries of the widened K1/K3, K6 and K7."""
    from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.core.types import COORD
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint, params_from_numpy
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_trunk, spec_from_net_params
    from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
    from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim

    cfg = load_config(office_name="tokyo")
    h, w = cfg.experiment.image_height, cfg.experiment.image_width
    _, _, meta = load_checkpoint(ROOM_CKPT)
    room_cfg = dataclasses.replace(
        cfg, rendering=dataclasses.replace(cfg.rendering, depth_range=tuple(meta["depth_range"])))
    room_init = COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0)
    room_poses = [poses_from_coordinates(room_init, [COORD(yaw=y)])[0] for y in ROOM_YAWS]
    click_poses = []
    for cls_name, *click in CLICKS:
        init, coord = getattr(ws, cls_name)(ckpt_path=CKPT, device=device).transform_relative_coordinates(*click)
        click_poses.append(poses_from_coordinates(init, [coord])[0])
    src = f"{PACKAGE}/csrc/"
    entries = []

    def renderer(ckpt, config, precision, preset, **kw):
        r = NeRFRenderer("tokyo", ckpt, config=config, precision=precision, preset=preset, device=device, **kw)
        r.initialize_models()
        return r

    def rays_of(pose, config):
        near, far = config.rendering.depth_range
        return create_rays(torch.as_tensor(pose, device=device), h, w, config.fx, config.fy, config.cx,
                           config.cy, near, far).reshape(h * w)

    # 2. K6 against its plain version at the turbo shapes (S=64, I=48, the
    # 4,800 stride-4 lattice rays of room pose 0 through the real proposal
    # pass) and at synth_hier's fast-preset shapes (S=64, I=128, 76,800).
    turbo_fast = renderer(ROOM_CKPT, room_cfg, "fast", "turbo")
    kp_prop, kp_student = turbo_fast.kernel_params["proposal"], turbo_fast.kernel_params["fine"]
    st = turbo_fast.settings
    rays = rays_of(room_poses[0], room_cfg)
    lat = torch.arange(h * w, device=device).reshape(h, w)[::STRIDE, ::STRIDE].reshape(-1)
    o_l, d_l = rays.origins[lat], rays.dirs[lat]
    o_ph_l, d_ph_l = fr.ray_phase_vectors(o_l, d_l, kp_prop.pts_freqs)
    z_l = coarse_z_vals(rays.near[lat], rays.far[lat], st.n_samples).T.contiguous()
    dist_l = fr._dists_from_z(z_l, torch.linalg.norm(d_l, dim=-1)[None])
    k1p = lambda kp, eps, live=None: fr.nerf_render(  # noqa: E731
        kp, o_ph_l, d_ph_l, z_l, dist_l, density_only=True, early_stop_eps=eps, live_groups=live)
    w_l = k1p(kp_prop, 0.0)
    torch.cuda.synchronize()
    k1p_err = float((w_l - fr.nerf_render_plain(kp_prop, o_ph_l, d_ph_l, z_l, dist_l, density_only=True)).abs().max())
    require(k1p_err <= BF16_ATOL, f"K1 proposal (64/F=6) disagrees: {k1p_err}")
    n_lat, s_c, n_imp = lat.numel(), st.n_samples, st.n_importance
    z_imp = im.importance_merge(w_l, z_l, n_imp, merge=False)
    torch.cuda.synchronize()
    k6_turbo = merge_check(z_imp, im.importance_merge_plain(w_l, z_l, n_imp, merge=False), z_l, slice(-1, None))
    z_hier = im.importance_merge(main["weights"], main["z_c"], 128, merge=False)
    torch.cuda.synchronize()
    k6_hier = merge_check(z_hier, im.importance_merge_plain(main["weights"], main["z_c"], 128, merge=False),
                          main["z_c"], slice(-1, None))
    k6 = lambda: im.importance_merge(w_l, z_l, n_imp, merge=False)  # noqa: E731
    k6_hier_fn = lambda: im.importance_merge(main["weights"], main["z_c"], 128, merge=False)  # noqa: E731
    t6 = dict(ms=time_ms(k6, 20), median=median_ms(k6), graph=graph_ms(k6, 20),
              plain=time_ms(lambda: im.importance_merge_plain(w_l, z_l, n_imp, merge=False), 5),
              ms_hier=time_ms(k6_hier_fn, 20), median_hier=median_ms(k6_hier_fn), graph_hier=graph_ms(k6_hier_fn, 20),
              plain_hier=time_ms(lambda: im.importance_merge_plain(main["weights"], main["z_c"], 128, merge=False), 5))
    b6, by6 = bound_ms(0, (2 * s_c + n_imp) * n_lat * 4)
    b6h, by6h = bound_ms(0, (2 * main["s_c"] + 128) * h * w * 4)
    print(f"K6 importance-only: turbo shapes (S={s_c}, I={n_imp}, R={n_lat}) ms {t6['ms']:.4f} plain_ms "
          f"{t6['plain']:.3f} bound_ms {b6:.5f} max_abs_err {k6_turbo[0]:.2e} flips {k6_turbo[1]:.4%} (off the "
          f"u = 1 row {k6_turbo[2]:.4%}); median of 5 readings {t6['median']:.4f}; as one CUDA graph of 20 "
          f"{t6['graph']:.4f}; launch floor {main['floor']:.4f} (median {main['floor_median']:.4f}) ms", flush=True)
    print(f"K6 importance-only: synth_hier fast shapes (S={main['s_c']}, I=128, R={h * w}) ms {t6['ms_hier']:.4f} "
          f"plain_ms {t6['plain_hier']:.3f} bound_ms {b6h:.5f} max_abs_err {k6_hier[0]:.2e} flips "
          f"{k6_hier[1]:.4%} (off the u = 1 row {k6_hier[2]:.4%}); median of 5 readings {t6['median_hier']:.4f}; "
          f"as one CUDA graph of 20 {t6['graph_hier']:.4f}", flush=True)

    # 3. K1/K3 at the student's shape against the plain version at eps 0: the
    # 6x192@10f full pass on all 76,800 rays at the lattice placement.
    z_s = z_imp.reshape(n_imp, h // STRIDE, 1, w // STRIDE, 1).expand(-1, -1, STRIDE, -1, STRIDE)
    z_s = z_s.reshape(n_imp, h * w).contiguous()
    o_ph_s, d_ph_s = fr.ray_phase_vectors(rays.origins, rays.dirs, kp_student.pts_freqs)
    venc_s = fr.encode_viewdirs_kernel_order(rays.viewdirs)
    dist_s = fr._dists_from_z(z_s, torch.linalg.norm(rays.dirs, dim=-1)[None])
    k3s = lambda kp, eps, live=None: fr.nerf_render(  # noqa: E731
        kp, o_ph_s, d_ph_s, z_s, dist_s, venc_s, early_stop_eps=eps, live_groups=live)
    k3s_plain = lambda kp: fr.nerf_render_plain(kp, o_ph_s, d_ph_s, z_s, dist_s, venc_s)  # noqa: E731
    maps_s = k3s(kp_student, 0.0)
    torch.cuda.synchronize()
    rgba = [0, 1, 2, 4]
    k3s_err = float((maps_s[rgba] - k3s_plain(kp_student)[rgba]).abs().max())
    require(k3s_err <= BF16_ATOL, f"K3 student (192/F=10) disagrees: {k3s_err}")

    def timed_pass(fn, kp, dense_samples, ray_bytes, n_rays_pass, density, peak):
        """(ms at eps 1e-3, samples evaluated, bound, bound_by, dense bound,
        full_pass_stats or None)."""
        live = torch.zeros(1, dtype=torch.int32, device=device)
        fn(kp, EPS, live)
        torch.cuda.synchronize()
        samples = int(live) * fr.STEP_POINTS
        mac, mac_ray = render_macs(kp, density)
        flops = 2 * (mac * samples + mac_ray * n_rays_pass)
        b, by = bound_ms(flops, ray_bytes + weight_bytes(kp), peak)
        dense, _ = bound_ms(2 * (mac * dense_samples + mac_ray * n_rays_pass), 0, peak)
        ms = time_ms(lambda: fn(kp, EPS), 5)
        return ms, samples, b, by, dense, None if density else full_pass_stats(kp, samples, ms, flops, b, peak)

    lat_bytes = 2 * 3 * n_lat * 4 + 3 * s_c * n_lat * 4
    stud_bytes = 2 * 3 * h * w * 4 + 2 * n_imp * h * w * 4 + 32 * h * w * 2 + 8 * h * w * 4
    ms, samples, b, by, dense, _ = timed_pass(k1p, kp_prop, s_c * n_lat, lat_bytes, n_lat, True, PEAK_BF16_FLOPS)
    t1p = dict(ms=ms, samples=samples, bound=b, by=by, dense=dense,
               plain=time_ms(lambda: fr.nerf_render_plain(kp_prop, o_ph_l, d_ph_l, z_l, dist_l, density_only=True), 2))
    ms, samples, b, by, dense, st3s = timed_pass(k3s, kp_student, n_imp * h * w, stud_bytes, h * w, False,
                                                 PEAK_BF16_FLOPS)
    t3s = dict(ms=ms, samples=samples, bound=b, by=by, dense=dense, plain=time_ms(lambda: k3s_plain(kp_student), 1))
    print(f"K1 proposal 2x64@6f (density, {n_lat} lattice rays x {s_c}): ms {t1p['ms']:.4f} plain_ms "
          f"{t1p['plain']:.3f} bound_ms {t1p['bound']:.5f} ({t1p['samples']} of {s_c * n_lat} samples evaluated) "
          f"max_abs_err {k1p_err:.2e}", flush=True)
    print(f"K3 student 6x192@10f (full, {h * w} rays x {n_imp}): ms {t3s['ms']:.3f} plain_ms {t3s['plain']:.3f} "
          f"bound_ms {t3s['bound']:.4f} ({t3s['samples']} of {n_imp * h * w} samples evaluated; dense bound "
          f"{t3s['dense']:.4f}) max_abs_err {k3s_err:.2e}; {stats_text(st3s, 'TFLOP/s')}", flush=True)
    entries += [
        dict(name="K1 fused render, density-only: proposal pass 2x64@6f (turbo/fast presets)", route="cuda",
             source=src + "fused_render.cu", replaces="nerf_workspaces_explorer_tpu/ops/pallas_render.py:598",
             max_abs_err=k1p_err, ms=t1p["ms"], plain_ms=t1p["plain"], bound_ms=t1p["bound"], bound_by=t1p["by"],
             library_ms=None, dense_bound_ms=t1p["dense"], rays=n_lat, samples=s_c, held_against_plain=True),
        dict(name="K3 fused render, full: student 6x192@10f (turbo preset, bf16)", route="cuda",
             source=src + "fused_render.cu", replaces="nerf_workspaces_explorer_tpu/ops/pallas_render.py:598",
             max_abs_err=k3s_err, ms=t3s["ms"], plain_ms=t3s["plain"], bound_ms=t3s["bound"], bound_by=t3s["by"],
             library_ms=None, dense_bound_ms=t3s["dense"], rays=h * w, samples=n_imp, held_against_plain=True,
             **st3s),
        dict(name="K6 importance-only placement: turbo shapes (4,800 lattice rays, 64 + 48)", route="cuda",
             source=src + "importance_merge.cu", replaces="nerf_workspaces_explorer_tpu/ops/pallas_sampling.py:47",
             max_abs_err=k6_turbo[0], ms=t6["ms"], plain_ms=t6["plain"], bound_ms=b6, bound_by=by6,
             library_ms=None, boundary_flips=k6_turbo[1], boundary_flips_off_u1_row=k6_turbo[2],
             ms_median_of_5=t6["median"], graph_ms=t6["graph"], launch_floor_ms=main["floor"], rays=n_lat, samples=s_c, importance=n_imp,
             held_against_plain=True),
        dict(name="K6 importance-only placement: synth_hier fast shapes (76,800 rays, 64 + 128)", route="cuda",
             source=src + "importance_merge.cu", replaces="nerf_workspaces_explorer_tpu/ops/pallas_sampling.py:47",
             max_abs_err=k6_hier[0], ms=t6["ms_hier"], plain_ms=t6["plain_hier"], bound_ms=b6h, bound_by=by6h,
             library_ms=None, boundary_flips=k6_hier[1], boundary_flips_off_u1_row=k6_hier[2],
             ms_median_of_5=t6["median_hier"], graph_ms=t6["graph_hier"], launch_floor_ms=main["floor"], rays=h * w, samples=main["s_c"],
             importance=128, held_against_plain=True),
    ]

    # 4. K7 against its plain version at eps 0: int8-trunk and int8, density
    # and full, on synth_hier's 8x256 nets (the main path's inputs) and on
    # the turbo nets.
    tree, _, _ = load_checkpoint(CKPT)
    turbo_tree, _, _ = load_checkpoint(os.path.join(HERE, "assets", "bench", "room_proposal.turbo.npz"))
    k7 = {}
    for heads in (False, True):
        mode = "int8" if heads else "int8-trunk"
        kps = {}
        for label, net in (("coarse", tree["coarse"]), ("fine", tree["fine"]),
                           ("proposal", turbo_tree["proposal"]), ("student", turbo_tree["fine"])):
            spec = spec_from_net_params(net)
            quant = calibrate_trunk(net, spec, heads=heads)
            kps[label] = fr.prepare_kernel_params(params_from_numpy(net, device), spec, quant=quant)
        cases = {
            "coarse density": (lambda kp, eps, live=None: fr.nerf_render(
                kp, main["o_ph"], main["d_ph"], main["z_c"], main["dist_c"], density_only=True,
                early_stop_eps=eps, live_groups=live), kps["coarse"], True,
                lambda kp: fr.nerf_render_plain(kp, main["o_ph"], main["d_ph"], main["z_c"], main["dist_c"],
                                                density_only=True), main["s_c"] * h * w, main["coarse_bytes"], h * w),
            "fine full": (lambda kp, eps, live=None: fr.nerf_render(
                kp, main["o_ph"], main["d_ph"], main["z_f"], main["dist_f"], main["venc"], early_stop_eps=eps,
                live_groups=live), kps["fine"], False,
                lambda kp: fr.nerf_render_plain(kp, main["o_ph"], main["d_ph"], main["z_f"], main["dist_f"],
                                                main["venc"]), main["s_f"] * h * w, main["fine_bytes"], h * w),
            "proposal density": (k1p, kps["proposal"], True,
                                 lambda kp: fr.nerf_render_plain(kp, o_ph_l, d_ph_l, z_l, dist_l, density_only=True),
                                 s_c * n_lat, lat_bytes, n_lat),
            "student full": (k3s, kps["student"], False, k3s_plain, n_imp * h * w, stud_bytes, h * w),
        }
        for case, (fn, kp, density, plain, dense_samples, nbytes, n_rays_pass) in cases.items():
            out = fn(kp, 0.0)
            torch.cuda.synchronize()
            ref = plain(kp)
            rows = slice(None) if density else rgba
            err = float((out[rows] - ref[rows]).abs().max())
            share = k7_share_exact(out, ref, rows)
            require(bool(torch.isfinite(out).all()), f"K7 {mode} {case}: non-finite output")
            require(err <= BF16_ATOL, f"K7 {mode} {case}: max |err| {err} against the plain version")
            ms, samples, b, by, dense, st = timed_pass(fn, kp, dense_samples, nbytes, n_rays_pass, density,
                                                       PEAK_INT8_OPS)
            plain_ms = time_ms(lambda: plain(kp), 1, warmup=0)
            k7[(mode, case)] = dict(err=err, share=share, ms=ms, samples=samples, bound=b, by=by, dense=dense,
                                    plain=plain_ms, rays=n_rays_pass, dense_samples=dense_samples, stats=st or {})
            print(f"K7 {mode} {case}: ms {ms:.3f} plain_ms {plain_ms:.2f} bound_ms {b:.4f} ({samples} of "
                  f"{dense_samples} samples evaluated; dense bound {dense:.4f}) max_abs_err {err:.2e}, rays "
                  f"agreeing to 1e-6 {share:.4%}" + (f"; {stats_text(st, 'TOP/s')}" if st else ""), flush=True)

    # 5. Serve 320x240 frames through the renderer: warm ms per frame (host
    # clock around render_pose_uint8 up to the device-to-host copy, median of
    # 6), exact launches per frame, SSIM >= 0.99 at stride 1 against the
    # parity frame of the same preset and pose, the served stride's SSIM
    # against stride 1, and exact block corners at eps 0.
    counters = (fr.LAUNCHES, im.LAUNCHES)

    def serve(r, poses):
        zero_launches(*counters)
        r.render_pose_uint8(poses[0]).cpu()  # warm-up: build, the eager frame, the frame graph's capture
        torch.cuda.synchronize()
        warm = {k: v for c in counters for k, v in c.items() if v}
        zero_launches(*counters)
        frames, ms = [], []
        for rep in range(SERVE_REPS):
            for pose in poses:
                t0 = time.perf_counter()
                frame = r.render_pose_uint8(pose).cpu().numpy()
                ms.append((time.perf_counter() - t0) * 1e3)
                if rep == 0:
                    frames.append(frame)
        kinds = sorted(render_pass(k) for k in warm)
        require(kinds == ["density_only", "full", "placement"] and all(v == 2 for v in warm.values()),
                f"warm-up launches {warm}: one density pass, one placement, one full pass eagerly and captured")
        require(not any(v for c in counters for v in c.values()), f"replayed frames called the wrappers: {counters}")
        ran = traced_render_passes(lambda: [r.render_pose_uint8(p).cpu() for p in poses])
        launches = {k: ran[render_pass(k)] for k in warm}
        require(all(v == len(poses) for v in launches.values()),
                f"{len(poses)} replayed frames ran {ran}: one density pass, one placement, one full pass per frame")
        live = torch.zeros(1, dtype=torch.int32, device=device)
        fr.render_rays_fused(r.kernel_params, rays_of(poses[0], r.config), r.settings, early_stop_eps=EPS,
                             grid_hw=(h, w), live_groups=live)
        for f in frames:
            require(f.dtype == np.uint8 and f.shape == (h, w, 3), f"frame {f.dtype} {f.shape}")
        return frames, float(np.median(ms)), launches, int(live) * fr.STEP_POINTS

    def parity_frames(ckpt, config, preset, poses, **kw):
        r = renderer(ckpt, config, "parity", preset, **kw)
        return [r.render_pose_uint8(p).cpu().numpy() for p in poses]

    rows = []  # (label, frames, ms, launches, samples, ssim list, extra)
    hier_parity = {"reference": main["parity_frames"],
                   "fast": parity_frames(CKPT, cfg, "fast", click_poses)}
    for precision, preset in (("int8", "reference"), ("int8-trunk", "reference"), ("fast", "fast")):
        r = renderer(CKPT, cfg, precision, preset)
        frames, ms, launches, samples = serve(r, click_poses)
        scores = [ssim(f / 255.0, p / 255.0) for f, p in zip(frames, hier_parity[preset])]
        extra = ""
        if preset == "fast":
            # The density pass at the caller's eps (csrc/fused_render.cu's
            # guard-resolved stop); from each click's eps-0 weights, the JAX
            # kernel's 4,096-ray tiles that would stop at that eps.
            tiles = []
            for pose in click_poses:
                rays = rays_of(pose, cfg)
                kp_c = r.kernel_params["coarse"]
                o_c, d_c = fr.ray_phase_vectors(rays.origins, rays.dirs, kp_c.pts_freqs)
                z_c = coarse_z_vals(rays.near, rays.far, r.settings.n_samples).T.contiguous()
                dist_c = fr._dists_from_z(z_c, torch.linalg.norm(rays.dirs, dim=-1)[None])
                w_c = fr.nerf_render(kp_c, o_c, d_c, z_c, dist_c, density_only=True, early_stop_eps=0.0)
                tiles.append(_script("profile_torch_placement_eps").jax_tile_stops(w_c, EPS))
            extra = f"; JAX 4096-ray tiles stopping at eps {EPS:g}: " + ", ".join(
                f"{a} of {b} ({c} rays above the guarded bound)" for a, b, c in tiles)
        rows.append((f"synth_hier {preset} {precision}", ms, launches, samples, scores, extra))
    room_parity = {p: parity_frames(ROOM_CKPT, room_cfg, p, room_poses, use_proposal=p == "fast")
                   for p in ("fast", "turbo")}
    for precision, preset in (("fast", "fast"), ("fast", "turbo"), ("int8", "turbo")):
        kw = dict(use_proposal=True) if preset == "fast" else {}
        served = renderer(ROOM_CKPT, room_cfg, precision, preset, **kw)
        require(served.settings.proposal_subsample == STRIDE, f"{preset} serves at stride "
                f"{served.settings.proposal_subsample}")
        frames, ms, launches, samples = serve(served, room_poses)
        exact = renderer(ROOM_CKPT, room_cfg, precision, preset, proposal_subsample=1, **kw)
        frames1 = [exact.render_pose_uint8(p).cpu().numpy() for p in room_poses]
        scores = [ssim(f / 255.0, p / 255.0) for f, p in zip(frames1, room_parity[preset])]
        s4 = [ssim(a / 255.0, b / 255.0) for a, b in zip(frames, frames1)]
        eps0 = [renderer(ROOM_CKPT, room_cfg, precision, preset, proposal_subsample=s, early_stop_eps=0.0, **kw)
                for s in (STRIDE, 1)]
        corner = max(float((eps0[0].render_pose(p)[::STRIDE, ::STRIDE] - eps0[1].render_pose(p)[::STRIDE, ::STRIDE])
                           .abs().max()) for p in room_poses)
        require(corner <= 1e-6, f"{preset} {precision}: block corners differ from stride 1 by {corner}")
        extra = (f"; stride {STRIDE} against stride 1: SSIM {', '.join(f'{x:.5f}' for x in s4)}, block corners "
                 f"max |diff| {corner:.1e} at eps 0")
        rows.append((f"room {preset} {precision}", ms, launches, samples, scores, extra))
        if (preset, precision) == ("turbo", "int8"):
            turbo_int8, turbo_int8_frames = served, frames
    for label, ms, launches, samples, scores, extra in rows:
        print(f"serve {label}: warm ms/frame {ms:.2f} (median of {SERVE_REPS * 3}); kernels run by a replayed "
              f"frame of each pose (profiler trace) {launches}; "
              f"samples evaluated (frame 1) {samples}; SSIM vs parity at stride 1 "
              f"{', '.join(f'{x:.5f}' for x in scores)}{extra}; card {card}", flush=True)
        require(min(scores) >= SSIM_GATE, f"{label}: SSIM {min(scores)} below {SSIM_GATE}")

    # Previews: synth_hier's coarse net in one pass; turbo's proposal pass and
    # an importance-only student pass at 32 samples.
    office = main["fast_office"]
    office.render_image_preview(*CLICKS[0][1:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preview = office.render_image_preview(*CLICKS[0][1:])
    hier_preview_ms = (time.perf_counter() - t0) * 1e3
    hier_preview_ssim = ssim(preview / 255.0, main["fast_frames"][0] / 255.0)
    turbo_int8.render_coordinates_preview(room_init, COORD(yaw=ROOM_YAWS[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preview = turbo_int8.render_coordinates_preview(room_init, COORD(yaw=ROOM_YAWS[0]))
    turbo_preview_ms = (time.perf_counter() - t0) * 1e3
    turbo_preview_ssim = ssim(preview / 255.0, turbo_int8_frames[0] / 255.0)
    print(f"preview: synth_hier (coarse net, one pass at 64 samples) {hier_preview_ms:.2f} ms, SSIM vs full "
          f"{hier_preview_ssim:.5f}; turbo int8 (proposal + importance-only at 32) {turbo_preview_ms:.2f} ms, "
          f"SSIM vs full {turbo_preview_ssim:.5f}; card {card}", flush=True)

    launches = {label: l for label, _, l, _, _, _ in rows}
    entries[0]["launches"] = launches["room turbo fast"]["density_only"]
    entries[1]["launches"] = launches["room turbo fast"]["full"]
    entries[2]["launches"] = launches["room turbo int8"]["importance_only"]
    entries[3]["launches"] = launches["synth_hier fast fast"]["importance_only"]
    # K7's entries: the passes a served row launched (turbo serves int8 only).
    nets = {"coarse density": ("synth_hier reference", "8x256"), "fine full": ("synth_hier reference", "8x256"),
            "proposal density": ("room turbo", "2x64@6f"), "student full": ("room turbo", "6x192@10f")}
    for (mode, case), k in k7.items():
        row, shape = nets[case]
        key = ("density_only" if "density" in case else "full") + ("_int8" if mode == "int8" else "_int8_trunk")
        n = launches.get(f"{row} {mode}", {}).get(key, 0)
        if not n:
            continue
        entries.append(dict(
            name=f"K7 fused render {mode}, {case} {shape}", route="cuda", source=src + "fused_render.cu",
            replaces="nerf_workspaces_explorer_tpu/ops/pallas_render.py:544", launches=n, max_abs_err=k["err"],
            ms=k["ms"], plain_ms=k["plain"], bound_ms=k["bound"], bound_by=k["by"], library_ms=None,
            rays_agreeing_1e6=k["share"], dense_bound_ms=k["dense"], rays=k["rays"], held_against_plain=True,
            **k["stats"]))
    return entries


def _script(name: str):
    """A module of scripts/ (the ablation and int4 probe scripts drive their
    kernels' paths; the placement script counts the JAX tiles)."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    return __import__(name)


def strips_phase(card: str, device: torch.device, pose) -> None:
    """The strip-pipelined frame of the main path's first click (module
    docstring)."""
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im

    def renderer(eps):
        r = NeRFRenderer("tokyo", CKPT, precision="fast", device=device, early_stop_eps=eps)
        r.initialize_models()
        return r

    exact = renderer(0.0)
    n = exact._pick_n_strips()
    same = np.array_equal(exact.render_pose_uint8_pipelined(pose), exact.render_pose_uint8(pose).cpu().numpy())
    require(same, "strips at eps 0 differ from the blocking frame")
    served = renderer(EPS)
    piped, blocking = served.render_pose_uint8_pipelined(pose), served.render_pose_uint8(pose).cpu().numpy()
    diff = int(np.abs(piped.astype(int) - blocking.astype(int)).max())
    torch.cuda.synchronize()
    counters = (fr.LAUNCHES, im.LAUNCHES)
    zero_launches(*counters)
    ms = []
    for _ in range(SERVE_REPS * 3):
        t0 = time.perf_counter()
        served.render_pose_uint8_pipelined(pose)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for c in counters for k, v in c.items() if v}
    want = {k: SERVE_REPS * 3 * n for k in ("density_only", "importance_merge", "full")}
    require(launches == want, f"strip launches {launches}, expected {want}")
    blocking_ms = []
    for _ in range(SERVE_REPS * 3):
        t0 = time.perf_counter()
        served.render_pose_uint8(pose).cpu()
        blocking_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"strips: synth_hier reference bf16, click 0, {n} strips of {served.config.experiment.image_height // n} "
          f"rows: bytes equal to blocking at eps 0 {same}; at eps {EPS:g} max |diff| {diff} levels; launches in "
          f"{SERVE_REPS * 3} frames {launches}; warm ms/frame pipelined {float(np.median(ms)):.2f}, blocking "
          f"{float(np.median(blocking_ms)):.2f} (medians of {SERVE_REPS * 3}); card {card}", flush=True)


def ablation_phase(card: str, device: torch.device):
    """K8 (module docstring); returns the kernels line's K8 entries."""
    from nerf_workspaces_explorer_tpu_torch.ops import fine_ablation as fa

    pfa = _script("profile_torch_fine_ablation")
    n_samples, width, height = 48, 640, 480
    kp, inputs = pfa.student_inputs(pfa.SIDECAR, n_samples, width, height, device)
    sps = fa._samples_per_step(n_samples, 32)
    check = [t[:, :4096].contiguous() for t in inputs]
    errs = {}
    for label, ablate in pfa.ROWS[1:]:
        ablate = frozenset(ablate)
        out = fa.run_ablation(kp, *check, ablate, samples_per_step=sps)
        torch.cuda.synchronize()
        ref = fa.run_ablation_plain(kp, *check, ablate, samples_per_step=sps)
        raw = "heads" in ablate or "epilogue" in ablate
        scale = max(1.0, float(ref[0:3].abs().max())) if raw else 1.0
        err = (out[[0, 1, 2, 5]] - ref[[0, 1, 2, 5]]).abs()
        share = float((err.amax(0) <= 1e-6 * scale).float().mean())
        require(bool(torch.isfinite(out).all()) and not out[[3, 4, 6, 7]].any(), f"K8 {label}: output rows")
        require(share >= 0.99 and float(err.max()) <= (2e-2 if raw else 2e-3) * scale,
                f"K8 {label}: {share:.4%} of rays agree to 1e-6 (x {scale:g}), max |err| {float(err.max())}")
        errs[label] = (float(err.max()), float(err.max()) / scale, share)
    zero_launches(fa.LAUNCHES)
    rows = pfa.attribution(kp, inputs, sps, reps=3)
    launches = dict(fa.LAUNCHES)
    print(f"K8 attribution, {os.path.relpath(pfa.SIDECAR, HERE)} int8 at {width}x{height} x {n_samples} "
          f"(sample groups of {sps}); launches {launches}; card {card}:", flush=True)
    pfa.print_rows(rows, n_samples, sps)
    entries = []
    for row in rows[1:]:
        ablate = frozenset(row["ablate"])
        mode = fa.mode_name(ablate)
        require(launches[mode] >= 1, f"K8 {row['label']} was not launched by the attribution run")
        plain_ms = time_ms(lambda: fa.run_ablation_plain(kp, *inputs, ablate, samples_per_step=sps), 1, warmup=0)
        err_abs, err_rel, share = errs[row["label"]]
        print(f"K8 {row['label']}: ms {row['ms']:.3f} plain_ms {plain_ms:.1f} bound_ms {row['bound_ms']:.4f} "
              f"max_abs_err {err_abs:.2e} (rel {err_rel:.2e}), rays agreeing {share:.4%}", flush=True)
        entries.append(dict(
            name=f"K8 fine-pass ablation {row['label']} (4x128@8f int8, {width}x{height} x {n_samples})",
            route="cuda", source=f"{PACKAGE}/csrc/fused_render.cu", replaces="scripts/profile_fine_ablation.py:54",
            launches=launches[mode], max_abs_err=err_abs, max_rel_err=err_rel, rays_agreeing_1e6=share,
            ms=row["ms"], plain_ms=plain_ms, bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            removed_ms=row["removed_ms"], full_pass_ms=rows[0]["ms"], held_against_plain=True))
    return entries


def int4_phase(card: str, device: torch.device):
    """K9 (module docstring); returns the kernels line's K9 entries."""
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.ops import int4_probe as ip

    p4 = _script("probe_int4_torch")
    np.random.seed(0)
    entries, legs = [], (("int4-operand", False, "scripts/probe_int4_tpu.py:42"),
                         ("int4x2-packed-bytes", True, "scripts/probe_int4_tpu.py:72"))
    # The launch floor, an empty kernel through a ctypes binding, read the
    # three ways K9 is: one events reading of 50 launches, the median of 5
    # such, one CUDA graph of 20.
    floor_fn = lambda: im.empty_launch(device)  # noqa: E731
    floor = dict(ms=time_ms(floor_fn, 50), median=median_ms(floor_fn, 50), graph=graph_ms(floor_fn, 20))
    print(f"launch floor (K9's readings): ms {floor['ms']:.5f} (CUDA events over 50 launches), median of 5 "
          f"readings {floor['median']:.5f}, {floor['graph']:.5f} as one CUDA graph of 20", flush=True)
    res = {}
    for name, packed, _ in legs:
        a, b, ref = p4.leg_inputs(packed, device)
        out = ip.int4_matmul(a, b, packed=packed)
        torch.cuda.synchronize()
        plain = ip.int4_matmul_plain(a, b, packed=packed)
        err_abs = float((out - plain).abs().max())
        err, err_plain = p4.rel_err(out, ref), err_abs / float(plain.abs().max())
        require(err < p4.TOL and err_plain < p4.TOL, f"K9 {name}: rel err {err} (numpy), {err_plain} (plain)")
        widened = ip.unpack_int4_rows(a) if packed else a
        k9 = lambda: ip.int4_matmul(a, b, packed=packed)  # noqa: E731
        t = dict(ms=time_ms(k9, 50), median=median_ms(k9, 50), graph=graph_ms(k9, 20),
                 plain=time_ms(lambda: ip.int4_matmul_plain(a, b, packed=packed), 50),
                 lib=time_ms(lambda: torch.matmul(widened.to(torch.bfloat16), b), 50))
        m, k = widened.shape
        n = b.shape[1]
        bound = bound_ms(2 * m * n * k, a.numel() * a.element_size() + b.numel() * 2 + m * n * 4)
        res[name] = (err, err_abs, err_plain, t, bound)
        print(f"K9 {name} ({m}x{k} @ {k}x{n}): ms {t['ms']:.4f} (median of 5 readings {t['median']:.4f}, as one "
              f"CUDA graph of 20 {t['graph']:.4f}) plain_ms {t['plain']:.4f} library_ms (torch.matmul "
              f"of the widened bf16 matrix) {t['lib']:.4f} bound_ms {bound[0]:.6f} ({bound[1]}); rel err "
              f"{err:.2e} against numpy, {err_plain:.2e} against plain; card {card}", flush=True)
    zero_launches(ip.LAUNCHES)
    np.random.seed(0)
    verdicts = p4.run_legs(device)
    launches = dict(ip.LAUNCHES)
    require(launches == {"int4_operand": 1, "int4x2_packed": 1}, f"K9 launches {launches}")
    require(all(err < p4.TOL for _, err in verdicts), f"int4 probe verdicts {verdicts}")
    print("int4 probe: " + "; ".join(f"[{n}] OK (rel err {e:.3g})" for n, e in verdicts) + "; INT4 VIABLE; card "
          + card, flush=True)
    for (name, packed, replaces), key in zip(legs, ("int4_operand", "int4x2_packed")):
        err, err_abs, err_plain, t, bound = res[name]
        entries.append(dict(
            name=f"K9 int4 probe leg {name} (128x128x128, widened to bf16)", route="cuda",
            source=f"{PACKAGE}/csrc/int4_probe.cu", replaces=replaces, launches=launches[key], max_abs_err=err_abs,
            max_rel_err=err, rel_err_vs_plain=err_plain, ms=t["ms"], ms_median_of_5=t["median"], graph_ms=t["graph"],
            launch_floor_ms=floor["ms"], launch_floor_median_ms=floor["median"], launch_floor_graph_ms=floor["graph"],
            plain_ms=t["plain"], bound_ms=bound[0], bound_by=bound[1], library_ms=t["lib"], held_against_plain=True))
    return entries

APP_TIMED_CLICKS = 6  # GUI clicks timed warm, each from the click to its installed full frame
REPLICA_SIZE = (640, 480)  # width, height of a Replica frame (the dataset's renders)
REPLICA_FRAMES = 100  # of a Sequence_1's ~900
REPLICA_GT_SAMPLES = 64  # the room recipe marches 320; 64 keeps 100 frames at 640x480 to seconds
REPLICA_TRAIN_SIZE = (320, 240)  # the stock config's image size: the loader resizes to it
MIXED_FILTER_EVERY = 10  # every 10th frame's rows cycle through the five PNG filters


class PPMPhoto:
    """Stands in for tk.PhotoImage(data=<PPM bytes>, format="PPM"); keeps
    the pixels it was handed."""

    def __init__(self, data, format):
        magic, size, maxval, pixels = data.split(b"\n", 3)
        require(format == "PPM" and magic == b"P6" and maxval == b"255", "gui_tk handed Tk a malformed PPM")
        self.width, self.height = map(int, size.split())
        self.pixels = np.frombuffer(pixels, np.uint8).reshape(self.height, self.width, 3)


def queued_root(base):
    """A fake Tk root whose after() queues, as Tk's does: posted callbacks
    run when this (the UI) thread pumps, not on the worker that posted."""
    import queue

    class QueuedRoot(base):
        def __init__(self):
            super().__init__()
            self.posted = queue.Queue()

        def after(self, _ms, callback):
            self.posted.put(callback)

        def pump(self, until, timeout=120.0):
            deadline = time.time() + timeout
            while not until():
                self.posted.get(timeout=max(0.0, deadline - time.time()))()

    return QueuedRoot()


def app_phase(card: str, device: torch.device) -> dict:
    """The explorer app (module docstring): the real gui_qt and gui_tk
    classes on duck-typed toolkits (tests/fake_toolkits.py), synth_hier at
    the reference preset, precision "fast"; returns the K1-K3 launches of
    the full frames and of the previews."""
    import importlib
    import threading
    import types

    from nerf_workspaces_explorer_tpu_torch.app import assets
    from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.utils.png import read_png
    # By path: a `tests` package installed on the machine would shadow the checkout's tests/.
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from fake_toolkits import QtEvent, TkEvent, TkRoot, install_fake_pyqt5, make_fake_tk, restore_modules

    out_dir = os.path.join(HERE, "build", "torch_kernels", "smoke_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    ws.ASSETS_DIR = os.path.join(out_dir, "workspaces")  # placeholders here, not in the checkout's assets/
    spots = {}
    for cls_name, rel_x, rel_y, *_ in CLICKS:
        spots.setdefault(cls_name, (rel_x, rel_y))
    offices = [getattr(ws, name)(ckpt_path=CKPT, precision="fast", device=device) for name in spots]
    for office in offices:
        paths = assets.ensure_assets(office)
        h, w = office.floor_plan_scale
        want = {"floor_plan": assets.make_floor_plan(office.name, h, w),
                "floor_plan_coordinate_systems": assets.make_coordinate_systems_plan(office.name, h, w),
                "thumbnail": assets.make_thumbnail(office.name, seed=hash(office.name) % 1000)}
        for key, array in want.items():
            require(paths[key].startswith(out_dir) and np.array_equal(read_png(paths[key]), array),
                    f"{office.name} {key}: the placeholder does not read back byte-equal")
    print(f"app assets: {3 * len(offices)} placeholders written by utils/png.py under a temporary directory "
          f"read back byte-equal", flush=True)

    counters = (fr.LAUNCHES, im.LAUNCHES)
    calls = []  # (kind, launches) of every render the GUIs asked for

    def kernels():
        return {"K1": fr.LAUNCHES["density_only"], "K2": im.LAUNCHES["importance_merge"],
                "K3": fr.LAUNCHES["full"]}

    # A full frame is a replay of the frame graph that the explorer's
    # warm-up captured: it calls no wrapper.
    replayed = {"K1": 0, "K2": 0, "K3": 0}

    for office in offices:
        for kind in ("render_image", "render_image_preview"):
            def counted(*args, _f=getattr(office, kind), _kind=kind):
                before = kernels()
                with contextlib.redirect_stdout(io.StringIO()):  # render_image's console trace
                    frame = _f(*args)
                after = kernels()
                calls.append((_kind, {k: after[k] - before[k] for k in after}))
                return frame
            setattr(office, kind, counted)

    def serial(office, args):
        """Workspace.render_image of the same click, on this thread."""
        with contextlib.redirect_stdout(io.StringIO()):
            return type(office).render_image(office, *args)

    # Qt: synchronous on the UI thread, a preview then the full frame.
    previous = install_fake_pyqt5()
    sys.modules.pop(f"{PACKAGE}.app.gui_qt", None)
    images = []
    qpixmap = sys.modules["PyQt5.QtGui"].QPixmap
    from_image = qpixmap.fromImage
    qpixmap.fromImage = staticmethod(lambda image: images.append(image) or from_image(image))
    try:
        gui_qt = importlib.import_module(f"{PACKAGE}.app.gui_qt")
        zero_launches(*counters)
        calls.clear()
        landing = gui_qt.LandingPage(offices)
        qt_ms, qt_frames = [], 0
        for office in offices:
            explorer = gui_qt.WorkspaceExplorer(landing, office)
            (rel_x, rel_y), (h, w) = spots[type(office).__name__], office.floor_plan_scale
            for i in range(5):  # the plan at serving's spot, then the four turn buttons
                calls.clear()
                if i == 0:
                    explorer._plan.mousePressEvent(QtEvent(round(rel_x * w), round(rel_y * h)))
                    require(explorer.state.render_args() == (rel_x, rel_y, 0, 0), f"Qt click gave "
                            f"{explorer.state.render_args()}")
                    buttons = {b.text(): b for b in explorer._view_widgets if hasattr(b, "click")}
                else:
                    buttons["←↑→↓"[i - 1]].click()
                want = serial(office, explorer.state.render_args())
                require(np.array_equal(explorer.frame_shown, want) and images[-1].data == want.tobytes(),
                        f"Qt {office.name} {explorer.state.render_args()}: the installed frame is not "
                        "Workspace.render_image's")
                require([k for k, _ in calls] == ["render_image_preview", "render_image"] and calls[1][1] == replayed,
                        f"Qt click launches {calls}: the full frame a replay")
                qt_frames += 1
            for _ in range(APP_TIMED_CLICKS if office is offices[0] else 0):
                t0 = time.perf_counter()
                buttons["←"].click()
                qt_ms.append((time.perf_counter() - t0) * 1e3)
            if office is offices[0]:  # one more click, its kernels from a profiler trace
                calls.clear()
                ran = traced_render_passes(buttons["←"].click)
                qt_traced = {"K1": ran["density_only"], "K2": ran["placement"], "K3": ran["full"]}
                traced_preview = calls[0][1]
                require(calls[1][1] == replayed and qt_traced == {k: v + 1 for k, v in traced_preview.items()},
                        f"a traced Qt click ran {qt_traced}, its preview launched {traced_preview}: K1, K2 and K3 "
                        "once for the full frame")
            explorer._return_to_floor_plan()
            require(explorer.state.render_args() == (0.0, 0.0, 0, 0) and explorer._plan in explorer._layout.items,
                    "Qt back to the floor plan")
            explorer._return_to_landing_page()
            require(landing.isVisible() and not explorer.isVisible(), "Qt back to the landing page")
        qt_launches = kernels()
    finally:
        qpixmap.fromImage = staticmethod(from_image)
        sys.modules.pop(f"{PACKAGE}.app.gui_qt", None)
        restore_modules(previous)
    preview = [c for k, c in calls if k == "render_image_preview"][-1]
    print(f"app qt: {qt_frames} clicks (the plan at serving's spots, then the four turn buttons) on "
          f"{', '.join(o.name for o in offices)}, each installed frame byte-equal to Workspace.render_image and a "
          f"replay of the frame graph; a traced click ran {qt_traced} (profiler trace), K1, K2, K3 once beside "
          f"its preview's {traced_preview}; launches over the flow (the explorers' warm-ups and the previews) "
          f"{qt_launches}; "
          "toolkit: tests/fake_toolkits.py", flush=True)

    # Tk: a worker thread per request, frames installed on the UI thread.
    try:
        import tkinter  # noqa: F401
    except ImportError:  # gui_tk's module constants need the names alone
        stub = types.ModuleType("tkinter")
        vars(stub).update(vars(make_fake_tk()))
        sys.modules["tkinter"] = stub
    gui_tk = importlib.import_module(f"{PACKAGE}.app.gui_tk")
    fake_tk = make_fake_tk()
    fake_tk.PhotoImage = PPMPhoto
    gui_tk.tk = fake_tk
    gui_tk.BTN_MAIN = {**gui_tk.BTN_MAIN, "relief": fake_tk.FLAT}
    gui_tk.BTN_CAMERA = {**gui_tk.BTN_CAMERA, "relief": fake_tk.FLAT}
    root = queued_root(TkRoot)
    landing = gui_tk.LandingPage(root, offices[:1])
    office = offices[0]
    thumb = root.find(lambda w: "<Button-1>" in w.bindings)[0]
    thumb.bindings["<Button-1>"](TkEvent(10, 10))
    plan = [w for w in root.find(lambda w: "<Button-1>" in w.bindings) if w is not thumb][0]
    explorer = plan.bindings["<Button-1>"].__self__
    installed = []
    install = explorer._install_frame
    explorer._install_frame = lambda image: installed.append(image) or install(image)
    main_thread = threading.get_ident()
    (rel_x, rel_y), (h, w) = spots[type(office).__name__], office.floor_plan_scale

    def request(action):
        """One request, pumped until its full frame is installed; the frame
        against the serial render of the same click on this thread."""
        installed.clear()
        calls.clear()
        t0 = time.perf_counter()
        action()
        root.pump(lambda: len(installed) == 2)
        ms = (time.perf_counter() - t0) * 1e3
        want = serial(office, explorer.state.render_args())
        require(np.array_equal(installed[1], want) and np.array_equal(explorer.frame_shown, want),
                f"Tk {explorer.state.render_args()}: the worker's frame is not the main thread's")
        require(calls[1][1] == replayed, f"Tk launches {calls}: the full frame a replay")
        return ms

    zero_launches(*counters)
    request(lambda: plan.bindings["<Button-1>"](TkEvent(round(rel_x * w), round(rel_y * h))))
    button = lambda text: root.find(lambda b: b.kwargs.get("text") == text and not b.destroyed)[0]  # noqa: E731
    for text in ("←", "↑", "→", "↓"):
        request(button(text).invoke)
    tk_ms = [request(button("←").invoke) for _ in range(APP_TIMED_CLICKS)]
    tk_launches = kernels()
    require(threading.get_ident() == main_thread, "pumped off the UI thread")

    # Two overlapping requests: the first mid-render when the second comes.
    entered, release = threading.Event(), threading.Event()
    counted_render = office.render_image

    def held(*args):
        entered.set()
        require(release.wait(120), "the held render was never released")
        return counted_render(*args)

    office.render_image = held
    installed.clear()
    explorer.state.turn_up()
    first = explorer._request_render()
    require(entered.wait(120), "the first request did not start")
    office.render_image = counted_render
    explorer.state.turn_down()
    second = explorer._request_render()
    release.set()
    for t in (first, second):
        t.join(120)
        require(not t.is_alive(), "a Tk worker did not finish")
    while not root.posted.empty():
        root.posted.get()()
    later = serial(office, explorer.state.render_args())
    require(len(installed) == 2 and np.array_equal(installed[-1], later),
            f"overlapping Tk requests installed {len(installed)} frames, the last equal to the later request's "
            f"serial frame: {np.array_equal(installed[-1], later) if installed else None}")

    # A failing render in the worker raises on the UI thread.
    def failing(*args):
        raise RuntimeError("render failed on purpose")

    office.render_image_preview = failing
    worker = explorer._request_render()
    worker.join(120)
    try:
        root.posted.get(timeout=120)()
        raise AssertionError("a failing render in the Tk worker did not raise on the UI thread")
    except RuntimeError as exc:
        require("on purpose" in str(exc), f"the UI thread raised {exc!r}")
    office.render_image_preview = type(office).render_image_preview.__get__(office)
    button("Back to Floor Plan").invoke()
    require(explorer._view_frame is None and explorer.state.render_args() == (0.0, 0.0, 0, 0),
            "Tk back to the floor plan")
    button("Explore another workspace").invoke()
    require(landing.frame.packed, "Tk back to the landing page")

    for o in offices:
        del o.render_image, o.render_image_preview  # the counting wrappers
    render_ms = []
    for _ in range(APP_TIMED_CLICKS):
        t0 = time.perf_counter()
        serial(office, (rel_x, rel_y, -30, 0))
        render_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    office.render_image_preview(rel_x, rel_y, -30, 0)
    preview_ms = (time.perf_counter() - t0) * 1e3
    med = lambda xs: float(np.median(xs))  # noqa: E731
    print(f"app tk: {len(tk_ms) + 5} requests on worker threads, each frame byte-equal to the main thread's "
          f"render; launches {tk_launches}; of two overlapping requests only the later frame installed (equal to "
          f"its serial render); a failing render raised on the UI thread", flush=True)
    print(f"app: warm ms from click to installed full frame (median of {APP_TIMED_CLICKS}): Qt {med(qt_ms):.2f} "
          f"(synchronous: preview + full frame), Tk {med(tk_ms):.2f} (worker thread, preview + full frame); "
          f"Workspace.render_image {med(render_ms):.2f}, one preview {preview_ms:.2f}; card {card}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"qt": qt_launches, "tk": tk_launches, "preview": preview, "qt_ms": med(qt_ms), "tk_ms": med(tk_ms),
            "render_ms": med(render_ms)}


MESH_TIME_REPS = 5  # warm readings (median) of the sharded frame and step
MESH_GRAPH_K = 10  # data-parallel steps a graph call in the mesh phase's graph leg
# The kernel counters each leg of the dry run must move, once a shard (the
# training step: both nets' K4 and K5 calls, twice a shard).
MESH_LEGS = {
    "train_step": ("train_field_w256f10v4_forward", "train_field_w256f10v4_backward"),
    "fused": ("render_density_only", "placement_importance_merge", "render_full"),
    "serving": ("render_density_only_int8", "placement_importance_merge", "render_full_int8"),
    "turbo": ("render_density_only_int8", "placement_importance_only", "render_full_int8"),
    "stride": ("render_density_only_int8", "placement_importance_only", "render_full_int8"),
    # the first graph call: K warm-up steps and the capture of K, both nets twice a step
    "train_graph": ("train_field_w256f10v4_forward", "train_field_w256f10v4_backward"),
    "train_graph_replays": (),  # a replay launches nothing through the wrappers
}
MESH_PER_SHARD = {"train_step": 2, "train_graph": 2 * 2 * MESH_GRAPH_K}
# Kernel ID -> the counters of its launches in the mesh phase.
MESH_COUNTERS = {
    "K1": ("render_density_only",), "K2": ("placement_importance_merge",), "K3": ("render_full",),
    "K4": ("train_field_w256f10v4_forward",), "K5": ("train_field_w256f10v4_backward",),
    "K6": ("placement_importance_only",), "K7": ("render_density_only_int8", "render_full_int8"),
}


def mesh_phase(card: str, device: torch.device) -> dict:
    """The device mesh (module docstring); returns each kernel counter's
    launches summed over the phase's dry runs."""
    from nerf_workspaces_explorer_tpu_torch.parallel import device_count
    from nerf_workspaces_explorer_tpu_torch.parallel.dryrun import dryrun_multigpu

    t_phase = time.time()
    meshes = [("data_mesh(1)", dict(n_devices=1)), ("[cuda:0]*2", dict(devices=[device] * 2)),
              ("[cuda:0]*4", dict(devices=[device] * 4))]
    if device_count() >= 2:
        meshes.append(("data_mesh(2)", dict(n_devices=2)))
    totals: dict = {}
    for label, kw in meshes:
        report = dryrun_multigpu(**kw, time_reps=MESH_TIME_REPS, graph_steps=MESH_GRAPH_K)
        n = report["n_devices"]
        per_shard = {}
        for leg, counts in report["launches"].items():
            per = MESH_PER_SHARD.get(leg, 1)
            require(set(counts) == set(MESH_LEGS[leg]) and all(v == per * n for v in counts.values()),
                    f"mesh {label} {leg}: launches {counts}, expected {MESH_LEGS[leg]} {per} a shard of {n}")
            per_shard[leg] = {k: v // n for k, v in counts.items()}
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        require(set(per_shard) == set(MESH_LEGS), f"mesh {label}: legs {sorted(per_shard)}")
        require(report["graph_loss_err"] <= 1e-6, f"mesh {label}: graphed steps' losses {report['graph_loss_err']}")
        ms = report["ms"]
        print(f"mesh {label}: {n} shards; train loss {report['loss']:.5f}, the single-device step on the "
              f"concatenated batch {report['loss_single']:.5f}, gradient rel {report['grad_rel']:.2e} (limit 0.08); "
              f"max |err| fused-vs-plain {report['fused_err']:.3e}, int8+proposal serving sharded-vs-single "
              f"{report['serving_err']:.3e}, turbo {report['turbo_err']:.3e}, stride-4 {report['stride_err']:.3e} "
              f"(limit 5e-3); uint8 frames byte-equal: serving {report['serving_bytes_equal']}, turbo "
              f"{report['turbo_bytes_equal']}, stride {report['stride_bytes_equal']}; launches per shard "
              f"{per_shard}; warm ms (median of {MESH_TIME_REPS}): 320x240 frame sharded {ms['frame_sharded']:.2f} "
              f"vs unsharded {ms['frame_single']:.2f}, data-parallel step {ms['step_sharded']:.2f} vs single "
              f"{ms['step_single']:.2f}; K = {MESH_GRAPH_K} graph: losses vs eager max |diff| "
              f"{report['graph_loss_err']:.1e} (limit 1e-6), a call / {MESH_GRAPH_K}: data-parallel step "
              f"{ms['step_sharded_graph']:.3f} vs graphed single-device step {ms['step_single_graph']:.3f} ms; "
              f"card {card}", flush=True)
    print(f"mesh phase: {time.time() - t_phase:.1f} s", flush=True)
    return totals


def replica_phase(card: str, device: torch.device) -> dict:
    """Training from a Replica-layout sequence (module docstring); returns
    the K4/K5 launches of its eager run."""
    from nerf_workspaces_explorer_tpu_torch.data import replica
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import render_room_ground_truth, room_scene, walkthrough_poses
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer
    from nerf_workspaces_explorer_tpu_torch.utils import png

    w, h = REPLICA_SIZE
    root = os.path.join(HERE, "build", "torch_kernels", "smoke_replica")
    shutil.rmtree(root, ignore_errors=True)
    scene_dir = os.path.join(root, "office0", "Sequence_1")  # Replica's own name for office_tokyo
    t0 = time.time()
    poses = walkthrough_poses(REPLICA_FRAMES)
    rgb, depth = render_room_ground_truth(room_scene(), poses, h, w, near=0.1, far=8.0,
                                          n_samples=REPLICA_GT_SAMPLES, device=device)
    rgb8 = np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)
    depth_mm = np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)
    gt_s = time.time() - t0
    # Frame i: every row with filter i % 5, or every 10th frame rows cycling
    # through the five.
    filters = [np.arange(h) % 5 if i % MIXED_FILTER_EVERY == MIXED_FILTER_EVERY - 1 else i % 5
               for i in range(REPLICA_FRAMES)]
    t0 = time.time()
    replica.write_sequence(scene_dir, rgb8, depth_mm, poses, filters)
    write_s = time.time() - t0

    # Every file decodes exactly to what was written (the loader's readers).
    decode = {name: [] for name in (*png.FILTERS, "mixed")}
    for i in range(REPLICA_FRAMES):
        t0 = time.perf_counter()
        got_rgb = replica.imread_rgb(os.path.join(scene_dir, "rgb", f"rgb_{i}.png"))
        got_depth = replica.imread_depth(os.path.join(scene_dir, "depth", f"depth_{i}.png"))
        decode["mixed" if np.ndim(filters[i]) else png.FILTERS[filters[i]]].append(time.perf_counter() - t0)
        require(np.array_equal(got_rgb, rgb8[i] / 255.0) and np.array_equal(got_depth, depth_mm[i] / 1000.0),
                f"frame {i}: the decoded PNGs differ from the arrays written")
    t0 = time.perf_counter()
    replica.resize_bilinear(rgb8[0] / 255.0, *REPLICA_TRAIN_SIZE)
    replica.resize_bilinear(depth_mm[0] / 1000.0, *REPLICA_TRAIN_SIZE)
    resize_s = time.perf_counter() - t0

    # Trainer(office) with no data loads the sequence itself.
    cfg = train_config()
    replica.DATASETS_PATH = root
    t0 = time.time()
    trainer = Trainer("office_tokyo", cfg, device=device, save_dir=os.path.join(root, "run"),
                      enable_tensorboard=False)
    load_s = time.time() - t0
    data = trainer._train_data, trainer._test_data
    train_ids, test_ids = replica.split_ids(REPLICA_FRAMES)
    tw, th = REPLICA_TRAIN_SIZE
    require(train_ids == list(range(0, REPLICA_FRAMES, 5)) and test_ids == [i + 2 for i in train_ids], "split ids")
    for split, ids in zip(data, (train_ids, test_ids)):
        require(split.rgb.shape == (len(ids), th, tw, 3) and np.array_equal(split.camera_pose, poses[ids]),
                f"a split's shape {split.rgb.shape} or poses: every 5th frame trains, +2 tests")
        k = len(ids) // 2
        want = replica.resize_bilinear(rgb8[ids[k]] / 255.0, tw, th).astype(np.float32)
        require(np.array_equal(split.rgb[k], want), f"frame {ids[k]}: the split's rgb is not its resized file")
    trainer.setup()

    def run(tr, steps_per_call):
        losses, ms = [], []
        for step in range(0, TRAIN_STEPS, steps_per_call):
            t0 = time.perf_counter()
            if steps_per_call == 1:
                losses.append(float(tr.step(step)["total_loss"]))
            else:
                losses.extend(tr.step_many(step)["total_loss_steps"].tolist())
            ms.append((time.perf_counter() - t0) * 1e3 / steps_per_call)
        k = TRAIN_WINDOW
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        require(np.isfinite(losses).all() and last < first, f"replica K={steps_per_call}: loss {first} -> {last}")
        return losses, first, last, float(np.median(ms[1:]))

    zero_launches(ff.LAUNCHES)
    losses, first, last, warm = run(trainer, 1)
    launches = dict(ff.LAUNCHES)
    want = {"forward": 2 * TRAIN_STEPS, "backward": 2 * TRAIN_STEPS,
            "backward_kernels": 2 * ff.BACKWARD_KERNELS * TRAIN_STEPS}
    require(launches == want, f"replica K4/K5 launches {launches}, expected {want}")
    graphed = Trainer("office_tokyo", cfg, train_data=data[0], test_data=data[1], device=device,
                      save_dir=os.path.join(root, "graphed"), enable_tensorboard=False, steps_per_call=GRAPH_K)
    graphed.setup()
    zero_launches(ff.LAUNCHES)
    g_losses, g_first, g_last, g_warm = run(graphed, GRAPH_K)
    g_diff = max(abs(a - b) for a, b in zip(g_losses, losses))
    require(graphed.graph_captured and g_diff <= 1e-6, f"replica graph: captured {graphed.graph_captured}, "
            f"losses against eager |diff| {g_diff}")
    n = len(train_ids) + len(test_ids)
    med = lambda xs: float(np.median(xs)) if xs else float("nan")  # noqa: E731
    print(f"replica sequence: {REPLICA_FRAMES} frames of the room walkthrough at {w}x{h} (ground truth "
          f"{REPLICA_GT_SAMPLES} samples, {gt_s:.1f} s), written by utils/png.py ({write_s:.1f} s, rgb 8-bit and "
          f"depth 16-bit mm, filters i % 5, every {MIXED_FILTER_EVERY}th frame all five by row); every file decoded "
          f"exactly; decode s/frame (rgb + depth) " + ", ".join(f"{k} {med(v):.4f}" for k, v in decode.items())
          + f"; resize to {tw}x{th} s/frame (rgb + depth) {resize_s:.4f}; card {card}", flush=True)
    print(f"replica load: Trainer('office_tokyo') with no data loaded {len(train_ids)} train / {len(test_ids)} test "
          f"frames (every 5th, +2) in {load_s:.2f} s ({load_s / 2:.2f} s per split, {load_s / n:.4f} s per frame)",
          flush=True)
    print(f"replica train: {TRAIN_STEPS} steps eager, loss first {TRAIN_WINDOW} {first:.5f} -> last {last:.5f}, "
          f"warm ms/step {warm:.2f}, K4/K5 launches {launches}; at steps_per_call={GRAPH_K} (CUDA graph) loss "
          f"{g_first:.5f} -> {g_last:.5f}, |diff| to eager {g_diff:.1e}, warm ms/step {g_warm:.2f}; card {card}",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "ms_step": warm, "ms_step_graph": g_warm}


QUALITY_ARGS = ["--steps", "3000", "--proposal", "--fast-preset", "--prop-subsample", "4"]  # the JAX gate's recipe
QUALITY_SPREAD_SEEDS = (1, 2, 3)  # further Trainer seeds of both legs, beside the gate's seed 0
PROPOSAL_DROP = "proposal test PSNR"  # the start of the gate's one failure that compares two trainings
# Kernel ID -> its counters (ops/fused_render.py, ops/importance_merge.py, ops/fused_field.py LAUNCHES).
QUALITY_COUNTERS = {
    "K1": ("render", "density_only"), "K2": ("placement", "importance_merge"), "K3": ("render", "full"),
    "K4": ("field", "forward"), "K5": ("field", "backward"), "K6": ("placement", "importance_only"),
    "K7": ("render", "density_only_int8", "full_int8"),
}


def _mip360_reference():
    """`benchmark/reference/mipnerf360.py`, the plain float32 mip-NeRF 360
    (it imports nothing of the port)."""
    import importlib.util

    path = os.path.join(HERE, "benchmark", "reference", "mipnerf360.py")
    spec = importlib.util.spec_from_file_location("bench_reference_mipnerf360", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mip360_launches(spec, rays: int) -> dict:
    """The kernel launches of one frame of `rays` rays
    (`ops/mipnerf360.py::render_rays_mip360`): a placement and a
    compositing a level; a K10 a chunk; a K11 a proposal chunk (the MLP in
    one launch) and one a layer of a NeRF chunk (the trunk, the bottleneck,
    the view and rgb layer)."""
    from nerf_workspaces_explorer_tpu_torch.ops import mipnerf360 as m3

    rp = -(-rays // m3.RAY_MULTIPLE) * m3.RAY_MULTIPLE
    levels = [*spec.prop_samples, spec.nerf_samples]
    chunks = [-(-rp // max(m3.RAY_MULTIPLE, (m3.CHUNK_ROWS // n) // m3.RAY_MULTIPLE * m3.RAY_MULTIPLE))
              for n in levels]
    return {"encode": sum(chunks), "linear": sum(chunks[:-1]) + chunks[-1] * (spec.nerf_depth + 2),
            "place": len(levels), "composite": len(levels)}


class Mip360Checks:
    """Patches `ops/mipnerf360.py`'s kernel wrappers so that each call of a
    frame also runs its plain version on the same inputs: each plain call's
    device ms (CUDA events) is added to its kernel's `plain_ms`, each
    kernel's worst gaps over the frame are kept, and every call is held at
    `tests/test_torch_gpu.py`'s tolerances (K10's widened where the frame's
    last interval reaches the far plane: `encode_slabs`)."""

    KEYS = ("encode", "linear", "place", "composite")

    def __init__(self, m3) -> None:
        self.m3 = m3
        self.plain_ms = dict.fromkeys(self.KEYS, 0.0)
        self.worst: dict = {}
        self.held = dict.fromkeys(self.KEYS, 0)
        self.level = -1
        self.real = {k: getattr(m3, k) for k in ("place", "encode_slabs", "prop_density_slabs", "nerf_slabs",
                                                  "composite")}

    def _plain(self, key, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.plain_ms[key] += start.elapsed_time(end)
        return out

    def _keep(self, name, value):
        self.worst[name] = max(self.worst.get(name, 0.0), float(value))

    def place(self, t_in, w_in, dilation, n, spec):
        self.level += 1
        s_k, t_k = self.real["place"](t_in, w_in, dilation, n, spec)
        s_p, _ = self._plain("place", lambda: self.m3.place_plain(t_in, w_in, dilation, n, spec))
        off = ((s_k - s_p).abs() > 2e-5).float().mean().item()
        t_err = ((t_k - self.m3.s_to_t(s_k, spec)).abs() / t_k.abs()).max().item()
        self._keep("place centres off by > 2e-5 (share)", off)
        self.held["place"] += 1
        # the CDF's sums in another order; a quantile on a flat stretch of
        # the CDF moves across it by an ulp (tests/test_torch_gpu.py)
        require(off <= 1e-3 and t_err <= 1e-5 and bool((s_k[:, 1:] >= s_k[:, :-1]).all()),
                f"K12 at level {self.level}: share off {off}, t rel err {t_err}")
        return s_k, t_k

    def encode_slabs(self, o, d, radii, tdist, model):
        out = self.real["encode_slabs"](o, d, radii, tdist, model)
        rows = tdist.shape[0] * (tdist.shape[1] - 1)
        p = self._plain("encode", lambda: self.m3.encode_plain(o, d, radii, tdist, model))
        full = self.m3.from_slabs(out, rows, self.m3.ENC_PAD)
        err = (full[:, : p.shape[1]].float() - p).abs()
        self._keep("K10 max |err|", err.max().item())
        self._keep("K10 mean |err|", err.mean().item())
        over = "K10 features over one ulp (the frame)"
        self.worst[over] = self.worst.get(over, 0) + int((err > 2**-8).sum())
        self.held["encode"] += 1
        # both bf16 (an ulp 2^-8 at |x| <= 1). Toward the far plane the
        # contraction's Jacobian along the ray, s + c|x|^2 = 1/|x|^2, is a
        # difference of two terms near 2/|x| and cancels in fp32, so the far
        # intervals' high-degree features carry errors of ~1e-3 in either
        # order of evaluation and land up to two ulps apart (one 320x240
        # frame on an H100: 9 of 12.3 M features, each a ray's last
        # interval at degree 11; the kernel 0.0074 from float64, the plain
        # 0.0031); elsewhere within one
        require(err.max().item() <= 2**-7 and err.mean().item() <= 1e-4 and bool((full[:, p.shape[1]:] == 0).all()),
                f"K10 at level {self.level}: max {err.max().item()}, mean {err.mean().item()}")
        return out

    def _raw_gap(self, raw, raw_p, what):
        gap = ((raw.sum(-1, keepdim=True) - raw_p).abs() - 2e-2 * raw_p.abs()).max().item()
        self._keep(f"{what} raw density |err| - 2e-2 |plain|", gap)
        return gap

    def prop_density_slabs(self, model, enc, rows, dens_out):
        self.real["prop_density_slabs"](model, enc, rows, dens_out)
        x = self.m3.from_slabs(enc, rows, model.spec.enc_dim).float()
        raw_p = self._plain("linear", lambda: self.m3.prop_density_plain(model, x))
        gap = self._raw_gap(dens_out, raw_p, "K11 proposal")
        self.held["linear"] += 1
        require(gap <= 2e-2, f"K11 proposal at level {self.level}: raw density gap {gap}")

    def nerf_slabs(self, model, enc, rows, vray, samples, dens_out, rgb_out):
        self.real["nerf_slabs"](model, enc, rows, vray, samples, dens_out, rgb_out)
        x = self.m3.from_slabs(enc, rows, model.spec.enc_dim).float()
        raw_p, rgb_p = self._plain("linear", lambda: self.m3.nerf_plain(model, x, vray, samples))
        gap = self._raw_gap(dens_out, raw_p, "K11 NeRF")
        err = (rgb_out - rgb_p).abs()
        self._keep("K11 NeRF rgb max |err|", err.max().item())
        self._keep("K11 NeRF rgb mean |err|", err.mean().item())
        self.held["linear"] += 1
        # bf16 activations through 8 layers: a row's sums in another order
        # move an activation by an ulp now and then
        require(gap <= 2e-2 and err.max().item() <= 2e-2 and err.mean().item() < 2e-3,
                f"K11 NeRF: raw density gap {gap}, rgb max {err.max().item()} mean {err.mean().item()}")

    def composite(self, tdist, raw, b_sigma, dnorm, rgb=None, need_weights=True):
        w, color = self.real["composite"](tdist, raw, b_sigma, dnorm, rgb, need_weights)
        w_p, c_p = self._plain("composite", lambda: self.m3.composite_plain(tdist, raw, b_sigma, dnorm, rgb))
        gaps = []
        if w is not None:
            gaps.append(((w - w_p).abs() - 1e-4 * w_p.abs() - 1e-6).max().item())
        if color is not None:
            gaps.append(((color - c_p).abs() - 1e-4 * c_p.abs() - 1e-5).max().item())
        self._keep("K13 |err| over rtol 1e-4 + atol", max(gaps))
        self.held["composite"] += 1
        require(max(gaps) <= 0, f"K13 at level {self.level}: {gaps}")
        return w, color

    def __enter__(self):
        for k in self.real:
            setattr(self.m3, k, getattr(self, k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.m3, k, fn)


def mip360_phase(card: str, device: torch.device) -> list:
    """mip-NeRF 360 at its published widths through `Workspace.render_image`
    (320x240, `assets/bench/mipnerf360_seeded.json`): warm ms a frame over
    4 clicks after 4 warm-up clicks; one more click profiled, with the
    launch counters set to 0 just before it, for each kernel's device ms
    and launches (held to `mip360_launches`) beside its bound; one more
    click with every kernel call held against its plain version on the
    same inputs (`Mip360Checks`), the plain versions' device ms over that
    frame the rows' plain ms; 512 rays of the path against the plain float32
    reference (`benchmark/reference/mipnerf360.py`). Returns the kernels'
    rows."""
    from nerf_workspaces_explorer_tpu_torch.app.workspace import OfficeTokyoWorkspace
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.obs.profiler import kernel_name
    from nerf_workspaces_explorer_tpu_torch.ops import mipnerf360 as m3

    t0 = time.perf_counter()
    h, w = 240, 320
    cfg = load_config(office_name="office_tokyo")
    cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(cfg.experiment, image_width=w, image_height=h))
    r = NeRFRenderer("office_tokyo", "assets/bench/mipnerf360_seeded.json", config=cfg, precision="fast",
                     preset="mipnerf360", device=device)
    space = OfficeTokyoWorkspace(renderer=r)
    space.initialize_models()
    model, spec = r._m360, r._m360.spec
    clicks = [(0.5, 0.6, 30 * k, (-30, 0, 30)[k % 3]) for k in range(4)]

    def click(c):
        with contextlib.redirect_stdout(io.StringIO()):
            return space.render_image(*c)

    frames = [click(c) for c in clicks]
    require(not np.array_equal(frames[0], frames[1]), "mip-NeRF 360: two clicks gave one frame")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for c in clicks:
        click(c)
    frame_ms = (time.perf_counter() - t1) / len(clicks) * 1e3

    zero_launches(m3.LAUNCHES)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        click(clicks[1])
        torch.cuda.synchronize()
    launches, want = dict(m3.LAUNCHES), mip360_launches(spec, h * w)
    require(launches == want, f"mip-NeRF 360 launches a frame {launches}, expected {want}")
    dev_ms: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            dev_ms[kernel_name(e.key)] = dev_ms.get(kernel_name(e.key), 0.0) + e.self_device_time_total / 1e3

    with Mip360Checks(m3) as checks:
        checked = click(clicks[2])
    require(np.array_equal(checked, frames[2]), "mip-NeRF 360: the checked click's frame differs from its first")
    # one MLP call a chunk
    held = dict(launches, linear=launches["encode"])
    require(checks.held == held, f"mip-NeRF 360 calls held {checks.held}, expected {held}")

    # 512 rays of the path against the plain float32 reference.
    plain = _mip360_reference()
    g = torch.Generator().manual_seed(0)
    o = torch.randn(512, 3, generator=g).to(device)
    d = torch.randn(512, 3, generator=g).to(device)
    v = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    rad = torch.full((512,), 2 / (160 * np.sqrt(12)), device=device)
    rgb = m3.render_rays_mip360(model, o, d, v, rad)
    sc = np.float32(spec.scene_scale)
    params, ref_spec = plain.load(os.path.join(HERE, "assets", "bench", "mipnerf360_seeded.json"), device)
    ref = plain.render_rays(params, o / sc, d / sc, v, rad / sc, ref_spec)
    err = (rgb - ref).abs()
    # tests/test_torch_gpu.py::test_m360_frame_matches_plain_reference
    require(err.mean().item() < 2e-3 and err.max().item() < 1.6e-2,
            f"mip-NeRF 360 against its plain reference: mean |err| {err.mean().item()}, max {err.max().item()}")

    rays, n = h * w, spec.nerf_samples
    shapes = spec.layer_shapes()
    mlp_flops = 2.0 * rays * (sum(spec.prop_samples) * sum(i * o_ for _, i, o_ in shapes["prop"])
                              + n * (sum(i * o_ for k, i, o_ in shapes["nerf"] if k != "view")
                                     + spec.bottleneck * spec.view_width) + spec.view_dim * spec.view_width)
    rows = rays * (sum(spec.prop_samples) + n)
    b10 = bound_ms(0, rows * 512 * 2)
    b11 = bound_ms(mlp_flops, 0)
    b12 = bound_ms(0, rays * 4 * 2 * sum(2 * k + 1 for k in (*spec.prop_samples, n)))
    b13 = bound_ms(0, rays * 4 * sum(2 * k + 1 for k in (*spec.prop_samples, n)))
    k11 = sum(v_ for k, v_ in dev_ms.items() if k.startswith("linear_kernel"))
    worst = ", ".join(f"{k} {v_:.3g}" for k, v_ in checks.worst.items())
    print(f"mip360 (8x1024 NeRF, 4x256 proposal, 64+64+32 samples, {w}x{h}): set-up {t1 - t0:.1f} s, warm "
          f"{frame_ms:.2f} ms a frame; one profiled frame: K11 {k11:.2f} ms ({b11[0] / k11 * 100:.1f}% of the bf16 "
          f"peak), K10 {dev_ms.get('encode_kernel', 0):.2f}, K12 {dev_ms.get('place_kernel', 0):.3f}, K13 "
          f"{dev_ms.get('composite_kernel', 0):.3f}, launches {launches}; one frame held against the plain "
          f"versions (plain ms {', '.join(f'{k} {v_:.1f}' for k, v_ in checks.plain_ms.items())}; worst over the "
          f"frame: {worst}); 512 rays vs plain float32 mean |err| {err.mean().item():.2e} max "
          f"{err.max().item():.2e}; card {card}", flush=True)
    src, common = f"{PACKAGE}/csrc/mipnerf360.cu", dict(route="cuda", replaces=None, library_ms=None,
                                                       held_against_plain=True, frame_ms=frame_ms)
    return [
        dict(name="K10 mip-NeRF 360 integrated encoding", source=src, ms=dev_ms.get("encode_kernel", 0.0),
             plain_ms=checks.plain_ms["encode"], bound_ms=b10[0], bound_by=b10[1], launches=launches["encode"],
             **common),
        dict(name="K11 mip-NeRF 360 dense layers (8x1024 NeRF, 4x256 proposal)", source=src, ms=k11,
             plain_ms=checks.plain_ms["linear"], bound_ms=b11[0], bound_by=b11[1], launches=launches["linear"],
             max_abs_err=err.max().item(), **common),
        dict(name="K12 mip-NeRF 360 placement", source=src, ms=dev_ms.get("place_kernel", 0.0),
             plain_ms=checks.plain_ms["place"], bound_ms=b12[0], bound_by=b12[1], launches=launches["place"],
             **common),
        dict(name="K13 mip-NeRF 360 compositing", source=src, ms=dev_ms.get("composite_kernel", 0.0),
             plain_ms=checks.plain_ms["composite"], bound_ms=b13[0], bound_by=b13[1],
             launches=launches["composite"], **common),
    ]


def quality_phase(card: str) -> dict:
    """The serving quality gate and the spread of its proposal comparison
    (module docstring); returns each kernel's launches summed over the
    gate's legs."""
    from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im

    t_phase = time.time()
    vq = _script("validate_quality_torch")
    counters = {"render": fr.LAUNCHES, "placement": im.LAUNCHES, "field": ff.LAUNCHES}
    legs = {}
    run_leg = vq.run_leg

    def counted_leg(name, *args, **kwargs):
        zero_launches(*counters.values(), *ff.SHAPE_LAUNCHES.values())
        leg = run_leg(name, *args, **kwargs)
        leg["launches"] = {k: sum(counters[c][key] for key in keys) for k, (c, *keys) in QUALITY_COUNTERS.items()}
        leg["field_libraries"] = {lib: dict(v) for lib, v in ff.SHAPE_LAUNCHES.items() if any(v.values())}
        legs[name] = leg
        return leg

    vq.run_leg = counted_leg
    out = os.path.join(HERE, "build", "torch_kernels", "smoke_quality")
    shutil.rmtree(out, ignore_errors=True)
    try:
        code = vq.main(QUALITY_ARGS + ["--out", out, "--report", os.path.join(out, "report.md")])
    finally:
        vq.run_leg = run_leg
    args = vq.build_parser().parse_args(QUALITY_ARGS + ["--out", out])
    with contextlib.redirect_stdout(io.StringIO()):  # the gate printed its lines above
        failures = vq.gate_failures(args, legs["hier"], legs["prop"])
    require((code == 0) == (not failures), f"quality gate: exit {code}, failures {failures}")
    steps = int(QUALITY_ARGS[1])
    totals = {}
    for name, leg in legs.items():
        n = leg["launches"]
        require(n["K4"] > 0 and n["K5"] > 0, f"quality {name}: no K4/K5 launch in training {n}")
        require(all(n[k] > 0 for k in ("K1", "K2", "K3", "K6", "K7")), f"quality {name}: a render kernel did "
                f"not launch {n}")
        fast = "; ".join(f"fast n_importance={k} PSNR {v['psnr']:.2f} (strided {v.get('psnr_sub', float('nan')):.2f})"
                         for k, v in sorted(leg["fast"].items(), reverse=True))
        print(f"quality {name}: test PSNR {leg['psnr']:.2f} dB (min {leg['psnr_min']:.2f}), SSIM {leg['ssim']:.4f} "
              f"(min {leg['ssim_min']:.4f}); fused vs fp32 SSIM {leg['fidelity']:.5f}, int8 vs fp32 SSIM "
              f"{leg['fidelity_int8']:.5f}; {fast}; {steps} steps in {leg['train_s']:.1f} s, "
              f"{leg['train_s'] * 1e3 / max(steps, 1):.2f} ms/step (one step a call at every 500th, CUDA-graph replays of "
              f"{vq.STEPS_PER_CALL} between); launches {n} (calls made eagerly or captured, replays "
              f"uncounted; by library {leg['field_libraries']}); card {card}", flush=True)
        for k, v in n.items():
            totals[k] = totals.get(k, 0) + v

    # Every gate that holds this run's models and kernels must pass. The
    # proposal-vs-hierarchical drop compares two independent trainings on
    # three test views, whose gap moves by more than its 0.7 dB from one
    # Trainer seed to the next; it is held on the mean over seeds 0-3.
    others = [f for f in failures if not f.startswith(PROPOSAL_DROP)]
    require(not others, f"the quality gate failed at {' '.join(QUALITY_ARGS)}: {others}")
    sp = _script("quality_seed_spread_torch")
    args.device = torch.device("cuda")
    rows = sp.spread(args, QUALITY_SPREAD_SEEDS, *sp.orbit_scene(args))
    gaps = [legs["prop"]["psnr"] - legs["hier"]["psnr"]] + [r["gap"] for r in rows]
    mean_gap = float(np.mean(gaps))
    print(f"quality gate at {' '.join(QUALITY_ARGS)} (seed 0, the JAX gate's thresholds): "
          f"{'PASSED' if not failures else 'FAILED: ' + '; '.join(failures)}; prop - hier test PSNR over seeds "
          f"0, {', '.join(map(str, QUALITY_SPREAD_SEEDS))}: {', '.join(f'{g:+.2f}' for g in gaps)} dB, mean "
          f"{mean_gap:+.2f} (held at > -{args.max_psnr_drop}); card {card}", flush=True)
    require(mean_gap > -args.max_psnr_drop, f"the proposal leg trails the hierarchical by {-mean_gap:.2f} dB on "
            f"the mean over seeds (allowed {args.max_psnr_drop})")
    print(f"quality phase: {time.time() - t_phase:.1f} s", flush=True)
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PACKAGE)) or not os.path.exists(CKPT):
        print(f"chip_smoke: run from a checkout of the repository ({PACKAGE}/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint, params_from_numpy
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import spec_from_config
    from nerf_workspaces_explorer_tpu_torch.ops import _build
    from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
    from nerf_workspaces_explorer_tpu_torch.ops import importance_merge as im
    from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
    from nerf_workspaces_explorer_tpu_torch.rays.sampling import coarse_z_vals
    from nerf_workspaces_explorer_tpu_torch.utils.metrics import ssim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. Build every kernel of the path from the checkout's sources.
    t0 = time.time()
    names = [*_build.VARIANTS, "importance_merge", "int4_probe"]
    field_libs = [n for n in names if n.startswith("train_field")]
    _build.build(names)
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "(C7" in line:
                print(f"ptxas {name}: {line.strip()}")
    spills = served_render_spills(names) + [x for n in field_libs + ["int4_probe"] for x in library_spills(n)]
    require(not spills, f"ptxas reports spills in served render, training field or int4 kernels: {spills}")
    serialized = served_render_serialized(names)
    for name in names:
        if name.startswith("fused_render_w"):
            print(f"ptxas gate {name}: {sum(x[0] == name for x in serialized)} render_kernel entries with C7520")
    require(not serialized, f"ptxas serializes the wgmma of served render kernels (C7520): {serialized}")
    n_place, bad_place = library_stack_or_spills("importance_merge")
    require(n_place >= 2 and not bad_place, f"importance_merge: {n_place} kernels reported, not stack- and "
            f"spill-free: {bad_place}")
    print(f"ptxas gate importance_merge: {n_place} kernels, each 0 bytes stack frame, 0 bytes spill stores, "
          f"0 bytes spill loads", flush=True)
    for name in names:
        if name.startswith("fused_render"):
            counts = sass_counts(name)
            print(f"sass {name}: {counts}", flush=True)
            if counts is not None:
                # Every served library holds the bf16 and int8 modes; K8's is int8 alone.
                need = ("IGMMA",) if "ablate" in name else ("HGMMA", "IGMMA")
                require(counts["HMMA"] == 0 and counts["IMMA"] == 0, f"{name}: mma.sync products remain {counts}")
                require(all(counts[op] > 0 for op in need), f"{name}: no wgmma {counts}")
    for name in field_libs + ["int4_probe"]:
        counts = sass_counts(name)
        print(f"sass {name}: {counts}", flush=True)
        if counts is not None:
            require(counts["HMMA"] == 0 and counts["IMMA"] == 0 and counts["HGMMA"] > 0,
                    f"{name}: the products must be wgmma alone {counts}")
    for name in field_libs:
        sass = library_sass(name)
        require(sass is not None, f"{name}: no cuobjdump to read the chain kernel's stores")
        stores, failures = field_chain_stores(sass, _build.build_log(name))
        print(f"sass gate {name}: {CHAIN_KERNEL} {stores['tma_stores']} TMA stores (UTMASTG), {stores['stg128']} "
              f"128-bit global stores; {failures or 'ok'}", flush=True)
        require(not failures, f"{name}: {failures}")

    # 2. Kernels against their plain versions at the main path's shapes.
    cfg = load_config(office_name="tokyo")
    spec = spec_from_config(cfg)
    tree, _, _ = load_checkpoint(CKPT)
    kp = {k: fr.prepare_kernel_params(params_from_numpy(tree[k], device, torch.bfloat16), spec)
          for k in ("coarse", "fine")}
    init, coord = ws.OfficeTokyoWorkspace(ckpt_path=CKPT).transform_relative_coordinates(*CLICKS[0][1:])
    pose = poses_from_coordinates(init, [coord])[0]
    h, w = cfg.experiment.image_height, cfg.experiment.image_width
    rays = create_rays(torch.as_tensor(pose, device=device), h, w, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                       *cfg.rendering.depth_range).reshape(h * w)
    n_rays, s_c, n_imp = h * w, cfg.rendering.n_samples, cfg.rendering.n_importance
    o_ph, d_ph = fr.ray_phase_vectors(rays.origins, rays.dirs)
    venc = fr.encode_viewdirs_kernel_order(rays.viewdirs)
    dir_norm = torch.linalg.norm(rays.dirs, dim=-1)[None]
    z_c = coarse_z_vals(rays.near, rays.far, s_c).T.contiguous()
    dist_c = fr._dists_from_z(z_c, dir_norm)

    k1 = lambda eps, live=None: fr.nerf_render(  # noqa: E731
        kp["coarse"], o_ph, d_ph, z_c, dist_c, density_only=True, early_stop_eps=eps, live_groups=live)
    weights = k1(0.0)
    torch.cuda.synchronize()
    weights_plain = fr.nerf_render_plain(kp["coarse"], o_ph, d_ph, z_c, dist_c, density_only=True)
    k1_err = float((weights - weights_plain).abs().max())
    require(k1_err <= BF16_ATOL, f"K1 coarse kernel disagrees: {k1_err}")

    z_f = im.importance_merge(weights, z_c, n_imp)
    torch.cuda.synchronize()
    z_f_plain = im.importance_merge_plain(weights, z_c, n_imp)
    k2_err, k2_flips, k2_flips_rest = merge_check(z_f, z_f_plain, z_c)
    dist_f = fr._dists_from_z(z_f, dir_norm)

    k3 = lambda eps, live=None: fr.nerf_render(  # noqa: E731
        kp["fine"], o_ph, d_ph, z_f, dist_f, venc, early_stop_eps=eps, live_groups=live)
    maps = k3(0.0)
    torch.cuda.synchronize()
    maps_plain = fr.nerf_render_plain(kp["fine"], o_ph, d_ph, z_f, dist_f, venc)
    k3_err = float(torch.cat([maps[0:3], maps[4:5]]).sub(torch.cat([maps_plain[0:3], maps_plain[4:5]])).abs().max())
    require(k3_err <= BF16_ATOL, f"K3 fine kernel disagrees on rgb/acc: {k3_err}")
    require(bool(torch.isfinite(maps).all() and torch.isfinite(weights).all()), "non-finite kernel output")

    # Times at the main path's arguments (early stop at the renderer's eps),
    # with the samples the blocks evaluated counted for the bound.
    live1 = torch.zeros(1, dtype=torch.int32, device=device)
    live3 = torch.zeros(1, dtype=torch.int32, device=device)
    k1(EPS, live1), k3(EPS, live3)
    torch.cuda.synchronize()
    samples1, samples3 = int(live1) * fr.STEP_POINTS, int(live3) * fr.STEP_POINTS
    reps = 5
    t = {
        "k1": time_ms(lambda: k1(EPS), reps), "k1_eps0": time_ms(lambda: k1(0.0), reps),
        "k1_plain": time_ms(lambda: fr.nerf_render_plain(kp["coarse"], o_ph, d_ph, z_c, dist_c, density_only=True), 2),
        "k2": time_ms(lambda: im.importance_merge(weights, z_c, n_imp), 20),
        "k2_median": median_ms(lambda: im.importance_merge(weights, z_c, n_imp)),
        "k2_plain": time_ms(lambda: im.importance_merge_plain(weights, z_c, n_imp), 5),
        "k3": time_ms(lambda: k3(EPS), reps), "k3_eps0": time_ms(lambda: k3(0.0), reps),
        "k3_plain": time_ms(lambda: fr.nerf_render_plain(kp["fine"], o_ph, d_ph, z_f, dist_f, venc), 2),
    }
    mac1, _ = render_macs(kp["coarse"], True)
    mac3, mac3_ray = render_macs(kp["fine"], False)
    ray_bytes = 2 * 3 * n_rays * 4  # base phases of o and d
    b1, by1 = bound_ms(2 * mac1 * samples1, ray_bytes + 3 * s_c * n_rays * 4 + weight_bytes(kp["coarse"]))
    b1_dense, _ = bound_ms(2 * mac1 * s_c * n_rays, 0)
    s_f = s_c + n_imp
    b3, by3 = bound_ms(2 * (mac3 * samples3 + mac3_ray * n_rays),
                       ray_bytes + 2 * s_f * n_rays * 4 + 32 * n_rays * 2 + 8 * n_rays * 4 + weight_bytes(kp["fine"]))
    b3_dense, _ = bound_ms(2 * (mac3 * s_f * n_rays + mac3_ray * n_rays), 0)
    st3 = full_pass_stats(kp["fine"], samples3, t["k3"], 2 * (mac3 * samples3 + mac3_ray * n_rays), b3,
                          PEAK_BF16_FLOPS)
    t["products_matmul"] = products_matmul_ms(kp["fine"], samples3)
    b2, by2 = bound_ms(0, (2 * s_c + s_f) * n_rays * 4)
    # The launch floor: an empty kernel through the placement kernel's
    # binding, timed as K2 and K6 are (CUDA events over 20 launches; the
    # median of 5 such readings), and as one CUDA graph of 20 (the device
    # alone).
    t["floor"] = time_ms(lambda: im.empty_launch(device), 20)
    t["floor_median"] = median_ms(lambda: im.empty_launch(device))
    t["floor_graph"] = graph_ms(lambda: im.empty_launch(device), 20)
    t["k2_graph"] = graph_ms(lambda: im.importance_merge(weights, z_c, n_imp), 20)
    print(f"K1 coarse density: ms {t['k1']:.3f} (eps 0: {t['k1_eps0']:.3f}) plain_ms {t['k1_plain']:.3f} "
          f"bound_ms {b1:.3f} ({samples1} of {s_c * n_rays} samples evaluated; dense bound {b1_dense:.3f}) "
          f"max_abs_err {k1_err:.2e}", flush=True)
    print(f"launch floor: an empty kernel through the importance_merge binding, ms {t['floor']:.5f} (CUDA "
          f"events over 20 launches), median of 5 readings {t['floor_median']:.5f}, {t['floor_graph']:.5f} as one "
          f"CUDA graph of 20; card {card}",
          flush=True)
    print(f"K2 importance merge: ms {t['k2']:.4f} plain_ms {t['k2_plain']:.3f} bound_ms {b2:.4f} "
          f"max_abs_err {k2_err:.2e} (boundary flips {k2_flips:.4%}; off the u = 1 rows {k2_flips_rest:.4%}); "
          f"median of 5 readings {t['k2_median']:.4f}; as one CUDA graph of 20 {t['k2_graph']:.4f}", flush=True)
    print(f"K3 fine full: ms {t['k3']:.3f} (eps 0: {t['k3_eps0']:.3f}) plain_ms {t['k3_plain']:.3f} "
          f"bound_ms {b3:.3f} ({samples3} of {s_f * n_rays} samples evaluated; dense bound {b3_dense:.3f}) "
          f"max_abs_err {k3_err:.2e}; {stats_text(st3, 'TFLOP/s')}; products_matmul_ms {t['products_matmul']:.3f} "
          f"(its products as bf16 torch.matmul over the {samples3} evaluated points, a yardstick)", flush=True)

    # 3. Serve clicks through the product path; parity renders on the card.
    offices = {}
    for cls_name in dict.fromkeys(c[0] for c in CLICKS):
        cls = getattr(ws, cls_name)
        fast, parity = cls(ckpt_path=CKPT, precision="fast"), cls(ckpt_path=CKPT, precision="parity")
        fast.initialize_models()
        parity.initialize_models()
        offices[cls_name] = (fast, parity)
        fast.render_image(*CLICKS[0][1:])  # warm-up: build, the eager frame, the frame graph's capture
        parity.render_image(*CLICKS[0][1:])
    torch.cuda.synchronize()
    zero_launches(fr.LAUNCHES, im.LAUNCHES)
    frames, fast_ms = [], []
    for cls_name, *click in CLICKS:
        t0 = time.perf_counter()
        frame = offices[cls_name][0].render_image(*click)  # ends in a device -> host copy
        fast_ms.append((time.perf_counter() - t0) * 1e3)
        frames.append(frame)
    require(sum(fr.LAUNCHES.values()) + sum(im.LAUNCHES.values()) == 0,
            f"replayed clicks called the render wrappers: {fr.LAUNCHES}, {im.LAUNCHES}")
    # A replay calls no wrapper: the kernels of the clicks' frames, once more,
    # from a profiler trace.
    with contextlib.redirect_stdout(io.StringIO()):  # render_image's console trace
        ran = traced_render_passes(lambda: [offices[c][0].render_image(*click) for c, *click in CLICKS])
    launches = {"K1": ran["density_only"], "K2": ran["placement"], "K3": ran["full"]}
    n_frames = len(CLICKS)
    require(launches == {"K1": n_frames, "K2": n_frames, "K3": n_frames}, f"launches {launches}")
    parity_ms, refs = [], []
    for (cls_name, *click), frame in zip(CLICKS, frames):
        require(frame.dtype == np.uint8 and frame.shape == (h, w, 3), f"frame {frame.dtype} {frame.shape}")
        t0 = time.perf_counter()
        ref = offices[cls_name][1].render_image(*click)
        parity_ms.append((time.perf_counter() - t0) * 1e3)
        refs.append(ref)
        score = ssim(frame / 255.0, ref / 255.0)
        diff = np.abs(frame.astype(int) - ref.astype(int))
        print(f"frame {cls_name} {click}: SSIM vs parity {score:.5f}, mean |diff| {diff.mean():.4f}, "
              f"max {diff.max()}, mean level {frame.mean():.2f}", flush=True)
        require(score >= SSIM_GATE, f"SSIM {score} below {SSIM_GATE}")
    require(not np.array_equal(frames[0], frames[1]), "two yaws of one spot gave one frame")
    print(f"serve: fast warm ms/frame {', '.join(f'{x:.1f}' for x in fast_ms)}; "
          f"parity warm ms/frame {', '.join(f'{x:.1f}' for x in parity_ms)}; kernels run by the clicks' "
          f"replayed frames (profiler trace) {launches}; "
          f"card {card}", flush=True)

    # 4. The explorer app: the GUIs' flows on duck-typed toolkits.
    app = app_phase(card, device)

    # 5. The strip-pipelined frame.
    strips_phase(card, device, pose)

    # 6. The serving presets and precisions.
    preset_kernels = presets_phase(card, device, dict(
        weights=weights, z_c=z_c, o_ph=o_ph, d_ph=d_ph, dist_c=dist_c, z_f=z_f, dist_f=dist_f, venc=venc,
        s_c=s_c, s_f=s_f, coarse_bytes=ray_bytes + 3 * s_c * n_rays * 4, floor=t["floor"],
        floor_median=t["floor_median"],
        fine_bytes=ray_bytes + 2 * s_f * n_rays * 4 + 32 * n_rays * 2 + 8 * n_rays * 4,
        parity_frames=refs, fast_office=offices[CLICKS[0][0]][0], fast_frames=frames))

    # 7. The fine-pass ablation (K8) and the int4 probe (K9).
    probe_kernels = ablation_phase(card, device) + int4_phase(card, device)

    # 8. Training from a Replica-layout sequence, then training.
    rep = replica_phase(card, device)
    mesh_launches = mesh_phase(card, device)
    train_kernels = train_phase(card, device)
    for entry, key in zip(train_kernels[:2], ("forward", "backward")):
        entry["replica_launches"] = rep["launches"][key]
        entry["replica_step_ms"], entry["replica_step_ms_graph"] = rep["ms_step"], rep["ms_step_graph"]

    # 9. Distillation.
    distill_kernels = distill_phase(card, device)

    # 10. The serving quality gate at the JAX package's default recipe.
    quality_launches = quality_phase(card)

    # 10b. mip-NeRF 360 at its published widths.
    m360_kernels = mip360_phase(card, device)

    # 11. The kernels line, then the result line.
    src = f"{PACKAGE}/csrc/"
    kernels = [
        dict(name="K1 fused render, density-only (coarse pass)", route="cuda", source=src + "fused_render.cu",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_render.py:598", launches=launches["K1"],
             max_abs_err=k1_err, ms=t["k1"], plain_ms=t["k1_plain"], bound_ms=b1, bound_by=by1,
             library_ms=None, ms_eps0=t["k1_eps0"], dense_bound_ms=b1_dense, held_against_plain=True,
             app_launches_qt=app["qt"]["K1"], app_launches_tk=app["tk"]["K1"]),
        dict(name="K2 importance merge", route="cuda", source=src + "importance_merge.cu",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_sampling.py:47", launches=launches["K2"],
             max_abs_err=k2_err, ms=t["k2"], plain_ms=t["k2_plain"], bound_ms=b2, bound_by=by2,
             library_ms=None, boundary_flips=k2_flips, boundary_flips_off_u1_rows=k2_flips_rest,
             ms_median_of_5=t["k2_median"], graph_ms=t["k2_graph"], launch_floor_ms=t["floor"],
             launch_floor_median_ms=t["floor_median"], launch_floor_graph_ms=t["floor_graph"],
             held_against_plain=True, app_launches_qt=app["qt"]["K2"], app_launches_tk=app["tk"]["K2"]),
        dict(name="K3 fused render, full (fine pass)", route="cuda", source=src + "fused_render.cu",
             replaces="nerf_workspaces_explorer_tpu/ops/pallas_render.py:598", launches=launches["K3"],
             max_abs_err=k3_err, ms=t["k3"], plain_ms=t["k3_plain"], bound_ms=b3, bound_by=by3,
             library_ms=None, ms_eps0=t["k3_eps0"], dense_bound_ms=b3_dense, held_against_plain=True,
             products_matmul_ms=t["products_matmul"], app_launches_qt=app["qt"]["K3"],
             app_launches_tk=app["tk"]["K3"], app_click_ms_qt=app["qt_ms"], app_click_ms_tk=app["tk_ms"],
             app_render_image_ms=app["render_ms"], **st3),
    ] + preset_kernels + train_kernels + distill_kernels + probe_kernels + m360_kernels
    for entry in kernels:
        counters = MESH_COUNTERS.get(entry["name"].split()[0])
        if counters:  # the kernel's launches over the mesh phase's dry runs
            entry["mesh_launches"] = sum(mesh_launches.get(c, 0) for c in counters)
        if entry["name"].split()[0] in quality_launches:  # its launches over the quality gate's legs
            entry["quality_launches"] = quality_launches[entry["name"].split()[0]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
