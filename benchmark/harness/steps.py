"""Cells that train: calls of K training steps back to back.

Set-up builds the generator's system (the program's trainer, the data and
the initial weights the benchmark made from the seed) and takes two judged
stretches of calls on it, each of at least `CHECK_STEPS` steps, which the
window's calls then follow on the same object:

- the start: the first calls, from the benchmark's initial weights (for a
  graphed trainer, the call that takes its steps eagerly and captures the
  CUDA graph);
- a stretch of the window's own path (for a graphed trainer, a replay of
  that graph), from the program's parameters and Adam state as they stand
  before it, cloned.

After the window the plain reference (`reference/train.py`) takes the same
steps from the same starts (the benchmark's weights and zero moments; the
cloned state) with the same draws, and the run compares each step's loss
and, after each stretch, the parameters' change and Adam's first moment,
leaf by leaf.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from harness import runtime
from harness import trace as trace_mod
from reference import train as ref_train

CHECK_STEPS = 3
NUMBERS = ("loss_gap", "change_gap", "median_change_gap", "median_moment_gap")

Tree = Dict[str, torch.Tensor]


class Window(NamedTuple):
    seconds: float  # host clock, ended by a synchronize
    steps: int
    errors: List[str]
    trace: Optional[trace_mod.Trace]
    tail_seconds: float  # the calls after the traced span (all of them untraced), ended by the synchronize
    tail_steps: int


class Stretch(NamedTuple):
    """A judged run of calls: the step it starts at, the program's state
    before it (None: the benchmark's initial weights and zero moments),
    each step's loss, and the parameters and Adam's first moment after."""

    start_step: int
    params0: Optional[Tree]
    moments0: Optional[Tuple[Tree, Tree]]
    losses: List[float]
    params: Tree
    m: Tree


class StepCell:
    def __init__(self, config: dict, mix: dict, cell: dict, gen, device, seed: int) -> None:
        self.config, self.mix, self.cell, self.gen = config, mix, cell, gen
        self.device = torch.device(device)
        self.seed = int(seed)
        self.system = gen.build(config, mix, self.device, self.seed)
        self.k = gen.steps_per_call(mix)
        self.next_step = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _snapshot(self) -> Tuple[Tree, Tuple[Tree, Tree]]:
        """Clones of the parameters and of Adam's two moments (zeros before
        the first step), by the reference's leaf names."""
        opt = self.gen.optimizer(self.system)
        names = self.gen.leaves(self.system["trainer"].params)
        params, m, v = {}, {}, {}
        for k, t in names.items():
            st = opt.state.get(t, {})
            params[k] = t.detach().clone()
            m[k] = st["exp_avg"].detach().clone() if "exp_avg" in st else torch.zeros_like(t)
            v[k] = st["exp_avg_sq"].detach().clone() if "exp_avg_sq" in st else torch.zeros_like(t)
        return params, (m, v)

    def stretch(self, from_init: bool) -> Stretch:
        """Calls until `CHECK_STEPS` steps or more are taken; from the
        benchmark's initial weights, or from the state cloned here."""
        start = self.next_step
        params0 = moments0 = None
        if not from_init:
            self._sync()
            params0, moments0 = self._snapshot()
        losses: List[float] = []
        while len(losses) < CHECK_STEPS:
            losses += [float(x) for x in self.gen.call(self.system, self.next_step).cpu()]
            self.next_step += self.k
        self._sync()
        params, (m, _) = self._snapshot()
        return Stretch(start, params0, moments0, losses, params, m)

    def window(self, seconds: float, trace: bool = False) -> Window:
        t_cfg = self.cell["trace"]
        t_lo, t_hi = (int(t_cfg["start"]), int(t_cfg["start"]) + int(t_cfg["units"])) if trace else (-1, -1)
        errors = []
        prof = prof_done = None
        self._sync()
        t0 = t_tail = time.perf_counter()
        i = i_tail = 0
        while True:
            if i == t_lo:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            try:
                if prof is not None:
                    with torch.profiler.record_function(trace_mod.UNIT_SPAN):
                        self.gen.call(self.system, self.next_step)
                        self._sync()
                else:
                    self.gen.call(self.system, self.next_step)
            except Exception as exc:  # a failed call is counted, and the loop goes on
                errors.append(f"{type(exc).__name__}: {exc}")
            self.next_step += self.k
            te = time.perf_counter()
            i += 1
            if prof is not None and i == t_hi:
                prof.__exit__(None, None, None)
                prof_done, prof = prof, None
                t_tail, i_tail = time.perf_counter(), i
            if te - t0 >= seconds and i >= t_hi:
                break
        self._sync()
        te = time.perf_counter()
        tr = trace_mod.read_profile(prof_done) if prof_done is not None else None
        return Window(te - t0, i * self.k, errors, tr, te - t_tail, (i - i_tail) * self.k)

    def free(self) -> None:
        self.gen.free(self.system)
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_spec(config: dict, mix: dict) -> dict:
    train = config["train"]
    near, far = train["depth_range"]
    return dict(n_rays=int(train["n_rays"]), n_samples=int(train["n_samples"]),
                n_importance=int(train["n_importance"]), near=float(near), far=float(far),
                raw_noise_std=float(train["raw_noise_std"]), learning_rate=float(train["learning_rate"]))


def stretch_steps(k: int) -> int:
    """Steps in a judged stretch of calls of k steps."""
    return -(-CHECK_STEPS // k) * k


def judge_stretch(st: Stretch, init: Tree, rays: dict, rgbs: torch.Tensor, config: dict, mix: dict, seed: int,
                  matmul: Callable = torch.matmul) -> Dict[str, float]:
    """The reference's steps from the stretch's start against the
    program's: the worst step's relative loss gap; the gap of the
    parameters' change over the stretch at the worst and the median leaf;
    the gap of Adam's first moment after it at the median leaf (leaves
    whose reference gradient at the stretch's first step is under a
    thousandth of the median leaf's are left out of both)."""
    start = init if st.params0 is None else {k: v.to(init[k].device) for k, v in st.params0.items()}
    rec = ref_train.run_steps(start, config["nets"], rays, rgbs, seed, len(st.losses), reference_spec(config, mix),
                              matmul=matmul, start_step=st.start_step, moments=st.moments0)
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(st.losses, rec.losses)]
    grad_norms = {k: float(g.norm()) for k, g in rec.first_grad.items()}
    median = float(np.median(list(grad_norms.values())))
    moved = [k for k, n in grad_norms.items() if n >= 1e-3 * median]
    prog_change = {k: st.params[k].to(start[k].device) - start[k] for k in start}
    ref_change = {k: rec.params[k] - start[k] for k in start}
    change = ref_train.leaf_gaps(prog_change, ref_change, keep=moved)
    moment = ref_train.leaf_gaps({k: v.to(start[k].device) for k, v in st.m.items()}, rec.m, keep=moved)
    return dict(loss_gap=max(loss_gaps), change_gap=max(change), median_change_gap=float(np.median(change)),
                median_moment_gap=float(np.median(moment)))


def judge(stretches: List[Stretch], init: Tree, rays: dict, rgbs: torch.Tensor, config: dict, mix: dict, seed: int,
          matmul: Callable = torch.matmul) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """Each number at its worst over the stretches, and each stretch's."""
    if len(stretches) < 2 or any(len(st.losses) < CHECK_STEPS for st in stretches):
        return {k: float("inf") for k in NUMBERS}, []
    per = [judge_stretch(st, init, rays, rgbs, config, mix, seed, matmul) for st in stretches]
    return {k: max(p[k] for p in per) for k in NUMBERS}, per


def run_cell(entry: dict, config: dict, mix: dict, cell: dict, gen, readers: Dict[str, object], *, seed: int,
             seconds: float, trace: bool, device, t_start: float) -> dict:
    sc = StepCell(config, mix, cell, gen, device, seed)
    stretches = [sc.stretch(from_init=True), sc.stretch(from_init=False)]
    setup_s = time.perf_counter() - t_start
    win = sc.window(seconds, trace)
    device_line = runtime.device_info(int(entry["chips"]), sc.device)
    bad = runtime.forbidden_modules()
    if bad:
        raise runtime.ForbiddenModules(bad)
    init = sc.system["init"]
    rays, rgbs = gen.reference_inputs(sc.system, mix, sc.device)
    sc.free()
    t_check = time.perf_counter()
    numbers, per_stretch = judge(stretches, init, rays, rgbs, config, mix, seed)
    check_s = time.perf_counter() - t_check
    checks = {name: {"value": numbers.get(name, float("inf")), "limit": float(limit)}
              for name, limit in cell["check"]["limits"].items()}
    correct = not win.errors and all(c["value"] <= c["limit"] for c in checks.values())
    ctx = dict(window=win, setup_s=setup_s, trace=win.trace, config=config, mix=mix, steps_per_call=sc.k)
    extra = dict(numbers=numbers, per_stretch=per_stretch, losses=[st.losses for st in stretches], check_s=check_s,
                 errors=win.errors[:3])
    return runtime.result_line(correct, win.steps, len(win.errors) * sc.k, readers, ctx, device_line, win.trace,
                               extra, checks)
