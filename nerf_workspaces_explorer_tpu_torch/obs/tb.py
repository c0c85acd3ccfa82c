"""TensorBoard metrics writer (counterpart of
`nerf_workspaces_explorer_tpu/obs/tb.py`).

Parity target: reference nerf/visualisation/tensorboard_writer.py:10-35
(SummaryWriter wrapper under `<experiment>/tensorboard_logs`, config text
dump, write_scalars, write_histogram). Degrades to a scalar-only sink when
no SummaryWriter backend is importable, so training never hard-depends on
TensorBoard. That sink keeps its history in memory and, on `flush` and
`close`, writes it under the log directory as JSON lines (`SCALARS_FILE`:
one {"tag", "step", "value"} object a scalar), which
`obs.export.scalars_from_tensorboard_logs` reads where there are no event
files, so a finished run's scalars outlive its process either way.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import yaml


# The scalar sink's history, under the log directory.
SCALARS_FILE = "scalars.jsonl"


class _NullSummaryWriter:
    """Records scalar history in memory and, given a log directory, writes
    it there as JSON lines on `flush`/`close`; ignores everything else."""

    def __init__(self, log_dir: Optional[str] = None) -> None:
        self.log_dir = log_dir
        self.scalars: Dict[str, List] = {}

    def add_scalar(self, tag: str, value, step: int) -> None:
        self.scalars.setdefault(tag, []).append((step, float(np.asarray(value))))

    def add_histogram(self, tag=None, values=None, global_step=None, **_) -> None:
        pass

    def add_image(self, *args, **kwargs) -> None:
        pass

    def add_text(self, *args, **kwargs) -> None:
        pass

    def flush(self) -> None:
        """Rewrite the history file with every scalar recorded so far."""
        if self.log_dir is None:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, SCALARS_FILE)
        with open(path + ".tmp", "w") as f:
            for tag, series in self.scalars.items():
                for step, value in series:
                    f.write(json.dumps({"tag": tag, "step": int(step), "value": value}) + "\n")
        os.replace(path + ".tmp", path)

    def close(self) -> None:
        self.flush()


def _make_summary_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return _NullSummaryWriter(log_dir)


class TensorboardWriter:
    """Experiment metrics sink (scalars, histograms, images, config dump)."""

    def __init__(
        self,
        experiment_dir: str,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._log_dir = os.path.join(experiment_dir, "tensorboard_logs")
        os.makedirs(self._log_dir, exist_ok=True)
        self.summary_writer = _make_summary_writer(self._log_dir)
        if config is not None:
            self.summary_writer.add_text(
                "Experiment arguments",
                str(yaml.dump(config, sort_keys=False, indent=4)),
                0,
            )

    def write_scalars(self, i_iter: int, values: Sequence, names: Sequence[str]) -> None:
        for value, name in zip(values, names):
            self.summary_writer.add_scalar(name, float(value), i_iter)

    def write_histogram(self, i_iter: int, values, name: str) -> None:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        self.summary_writer.add_histogram(
            tag=name, values=np.asarray(values), global_step=i_iter
        )

    def write_image(self, name: str, images: np.ndarray, i_iter: int) -> None:
        """images: [N, H, W, C] float in [0, 1]."""
        self.summary_writer.add_image(name, images, i_iter, dataformats="NHWC")

    def flush(self) -> None:
        self.summary_writer.flush()
