"""Per-phase wall-clock timing of the training loop, and profiler traces.

Counterpart of `nerf_workspaces_explorer_tpu/obs/profiler.py` (`StepTimer`,
and `trace_context`, here a `torch.profiler` trace where the JAX package
takes a `jax.profiler` one). A phase on a CUDA device ends with
`torch.cuda.synchronize()`, so its time includes the device work queued in
it, not only the host's launches. `device_kernel_counts` reads a
`torch.profiler` trace: how often each kernel ran on the card, the kernels
of CUDA-graph replays included.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StepTimer:
    """Accumulates wall-clock per named phase; cheap enough for every step."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        count = self.counts.get(name, 0)
        return self.totals[name] / count if count else 0.0

    def summary(self) -> Dict[str, float]:
        return {name: self.mean(name) for name in self.totals}

    def reset(self) -> None:
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
    """A profiler event's kernel name without return type and parameters:
    "void field_dw_kernel(DwJobs, int)" -> "field_dw_kernel"."""
    words = key.split("(")[0].split()
    return words[-1] if words else key


def device_kernel_counts(prof) -> Dict[str, int]:
    """Runs of each device kernel in a finished `torch.profiler.profile`
    (with the CUDA activity), by `kernel_name`."""
    counts: Dict[str, int] = defaultdict(int)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            counts[kernel_name(e.key)] += e.count
    return dict(counts)
