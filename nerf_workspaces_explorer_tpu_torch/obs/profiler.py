"""Per-phase wall-clock timing of the training loop.

Counterpart of `nerf_workspaces_explorer_tpu/obs/profiler.py` (`StepTimer`;
the trace context is not ported). A phase on a CUDA device ends with
`torch.cuda.synchronize()`, so its time includes the device work queued in
it, not only the host's launches.
"""

from __future__ import annotations

import contextlib
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
