"""Spans, counters and per-phase timing of the port, and profiler traces.

Counterpart of `nerf_workspaces_explorer_tpu/obs/profiler.py` (`StepTimer`,
and `trace_context`, here a `torch.profiler` trace where the JAX package
takes a `jax.profiler` one).

Tracing is on exactly while a `torch.profiler` session records (the CLI's
`--profile`, `trace_context`, or any `torch.profiler.profile` a caller
opens); nothing else turns it on. Then `span(name)` is a
`record_function`, which the trace holds as a `user_annotation` event on
the kernels' clock, and the program's counters count (`count`,
`device_counter`, `GraphCounters`, read by `read_counters`). Off, `span`
returns one shared no-op context and nothing is counted.

`StepTimer` times named phases: on a CUDA device by a pair of CUDA events
on the current stream, resolved when the times are read, so a phase never
waits for the device. `device_kernel_counts` reads a `torch.profiler`
trace: how often each kernel ran on the card, the kernels of CUDA-graph
replays included.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Callable, ContextManager, Deque, Dict, Iterator, List, Optional, Tuple

import torch

_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a `torch.profiler` session is recording on this process."""
    return torch.autograd._profiler_enabled()


def span(name: str) -> ContextManager:
    """A named span of the program's work: `record_function(name)` while
    tracing, else a shared no-op context: a flag check, where a
    `record_function` outside a trace costs ~20 times as much. Spans nest
    by containment on the calling thread."""
    return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF


# The program's counters, counted only while tracing: host counts, device
# int32 [1] counters that kernels add to, each with the number of units one
# of its counts stands for, and the runs of traced replays of `GraphCounters`
# (names, scale, the values before the run's first replay, after its last).
_HOST_COUNTS: Dict[str, int] = defaultdict(int)
_DEVICE_COUNTS: Dict[Tuple[str, torch.device], Tuple[torch.Tensor, int]] = {}
_GRAPH_RUNS: List[Tuple[Tuple[str, ...], int, torch.Tensor, torch.Tensor]] = []


def count(name: str, n: int) -> None:
    """Add n to the host counter `name`."""
    _HOST_COUNTS[name] += int(n)


def device_counter(name: str, device: torch.device, scale: int = 1) -> torch.Tensor:
    """The int32 [1] counter `name` on `device` for a kernel to add to (an
    int32 holds 2**31 - 1 counts); `read_counters` multiplies it by
    `scale`, fixed at its first use."""
    key = (name, torch.device(device))
    if key not in _DEVICE_COUNTS:
        _DEVICE_COUNTS[key] = (torch.zeros(1, dtype=torch.int32, device=key[1]), int(scale))
    return _DEVICE_COUNTS[key][0]


class GraphCounters:
    """int32 counters on a device that a CUDA graph's kernels add to at
    every replay, counted as `names` (each count times `scale`) over the
    replays made while tracing.

    `values` is the tensor the graph captures; `replay(launch)` calls
    `launch`, the graph's replay. The graph adds to `values` at every
    replay, traced or not, and never resets them (they wrap around int32),
    so a run of consecutive traced replays is counted by two copies of
    `values` on the device, from before its first replay and after its
    last: no kernel, no wait, and two copies however long the run.
    `reset_counters` drops the runs; the next traced replay starts one."""

    def __init__(self, names: Tuple[str, ...], device: torch.device, scale: int = 1) -> None:
        self.names, self.scale = tuple(names), int(scale)
        self.values = torch.zeros(len(self.names), dtype=torch.int32, device=device)
        self._run: Optional[Tuple[Tuple[str, ...], int, torch.Tensor, torch.Tensor]] = None

    def replay(self, launch: Callable[[], None]) -> None:
        if not tracing():
            self._run = None
            launch()
            return
        if not any(run is self._run for run in _GRAPH_RUNS):
            self._run = (self.names, self.scale, self.values.clone(), self.values.clone())
            _GRAPH_RUNS.append(self._run)
        launch()
        self._run[3].copy_(self.values)


def read_counters() -> Dict[str, int]:
    """Every counter as a host integer, its host and device parts summed.
    Waits for the device: read after the counted work."""
    out = dict(_HOST_COUNTS)
    for (name, _), (t, scale) in _DEVICE_COUNTS.items():
        out[name] = out.get(name, 0) + int(t.item()) * scale
    for names, scale, start, end in _GRAPH_RUNS:
        for name, a, b in zip(names, *torch.stack((start, end)).tolist()):
            out[name] = out.get(name, 0) + (b - a) % 2**32 * scale
    return out


def reset_counters() -> None:
    """Drop every counter; a later count starts a new one at 0."""
    _HOST_COUNTS.clear()
    _DEVICE_COUNTS.clear()
    _GRAPH_RUNS.clear()


class StepTimer:
    """Accumulates time per named phase; cheap enough for every step.

    On the CPU a phase is timed by the host clock. On a CUDA device it is a
    pair of CUDA events recorded on the current stream at its start and its
    end, so it never waits for the device: the time is the device's from
    the start event to the end event, the phase's own work when the host
    runs ahead, and the host's and the device's together when it does not.
    Pairs are resolved when `mean` or `summary` is read (which waits for the
    last), and completed ones whenever more than `MAX_PENDING` wait, so
    `totals` and `counts` hold the resolved phases."""

    MAX_PENDING = 64

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._pending: Deque[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = deque()

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def _resolve(self, wait: bool) -> None:
        while self._pending and (wait or self._pending[0][2].query()):
            name, start, end = self._pending.popleft()
            end.synchronize()
            self._add(name, start.elapsed_time(end) * 1e-3)

    @contextlib.contextmanager
    def phase(self, name: str, span_name: Optional[str] = None) -> Iterator[None]:
        """Time the block as phase `name`; with `span_name`, the block is
        also that span."""
        with span(span_name) if span_name else _OFF:
            if self.device is None or self.device.type != "cuda":
                start = time.perf_counter()
                try:
                    yield
                finally:
                    self._add(name, time.perf_counter() - start)
                return
            stream = torch.cuda.current_stream(self.device)
            start_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record(stream)
            try:
                yield
            finally:
                end_ev = torch.cuda.Event(enable_timing=True)
                end_ev.record(stream)
                self._pending.append((name, start_ev, end_ev))
                if len(self._pending) > self.MAX_PENDING:
                    self._resolve(wait=False)

    def mean(self, name: str) -> float:
        self._resolve(wait=True)
        count = self.counts.get(name, 0)
        return self.totals[name] / count if count else 0.0

    def summary(self) -> Dict[str, float]:
        self._resolve(wait=True)
        return {name: self.totals[name] / self.counts[name] for name in self.totals}

    def reset(self) -> None:
        self._pending.clear()
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[Optional["torch.profiler.profile"]]:
    """A `torch.profiler` trace of the block (the host's calls and, where
    CUDA is available, the card's kernels), written on exit as a Chrome
    trace to `<log_dir>/trace.json`; a no-op without a directory."""
    if log_dir is None:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without return type, namespaces,
    template arguments and parameters: "void field_dw_kernel(DwJobs, int)"
    -> "field_dw_kernel", "void rk::render_kernel<192, 10, 0, false>(...)"
    -> "render_kernel"; a name without parameters ("aten::copy_") as it
    is."""
    name = key.replace("(anonymous namespace)::", "")
    if "(" not in name:
        return key
    words = name.split("(")[0].split("<")[0].split()
    return words[-1].split("::")[-1] if words else key


def device_kernel_counts(prof) -> Dict[str, int]:
    """Runs of each device kernel in a finished `torch.profiler.profile`
    (with the CUDA activity), by `kernel_name`."""
    counts: Dict[str, int] = defaultdict(int)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            counts[kernel_name(e.key)] += e.count
    return dict(counts)
