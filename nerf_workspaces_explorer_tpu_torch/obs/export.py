"""Training-curve export (a copy of `nerf_workspaces_explorer_tpu/obs/export.py`,
which imports nothing of JAX, whose reader also takes the port's scalar sink).

Parity target: the reference publishes its results as TensorBoard-exported
SVG curves under nerf/results/office_*/ (9 per office: Train_Loss_*,
Train_Metric_*, Test_Metric_* — SURVEY.md component 22). This module renders
the same set of curves from a run's recorded scalars so results ship with
the repo in the same reviewable form.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Dict, List, Mapping, Sequence, Tuple

from nerf_workspaces_explorer_tpu_torch.obs.tb import SCALARS_FILE

# The reference's nine published chart names (SURVEY.md §2 component 22),
# mapped to our TensorBoard tags.
PUBLISHED_CHARTS = {
    "Train_Loss_rgb_loss_coarse": "Train/Loss/rgb_loss_coarse",
    "Train_Loss_rgb_loss_fine": "Train/Loss/rgb_loss_fine",
    "Train_Loss_total_loss": "Train/Loss/total_loss",
    "Train_Metric_psnr_coarse": "Train/Metric/psnr_coarse",
    "Train_Metric_psnr_fine": "Train/Metric/psnr_fine",
    "Train_Metric_batch_PSNR": "Train/Metric/batch_PSNR",
    "Train_Metric_batch_MSE": "Train/Metric/batch_MSE",
    "Test_Metric_batch_PSNR": "Test/Metric/batch_PSNR",
    "Test_Metric_batch_MSE": "Test/Metric/batch_MSE",
}


def _svg_line_chart(
    points: Sequence[Tuple[float, float]],
    title: str,
    width: int = 640,
    height: int = 360,
) -> str:
    """Minimal dependency-free SVG line chart."""
    if not points:
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}"/>'
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = min(ys), max(ys)
    x_span = (x_hi - x_lo) or 1.0
    y_span = (y_hi - y_lo) or 1.0
    pad = 45

    def sx(x: float) -> float:
        return pad + (x - x_lo) / x_span * (width - 2 * pad)

    def sy(y: float) -> float:
        return height - pad - (y - y_lo) / y_span * (height - 2 * pad)

    path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in points)
    ticks = []
    for frac in (0.0, 0.5, 1.0):
        yv = y_lo + frac * y_span
        ticks.append(
            f'<text x="4" y="{sy(yv):.0f}" font-size="11" fill="#555">{yv:.4g}</text>'
        )
        xv = x_lo + frac * x_span
        ticks.append(
            f'<text x="{sx(xv):.0f}" y="{height - 24}" font-size="11" fill="#555">{xv:.4g}</text>'
        )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'style="background:#fff">'
        f'<text x="{width/2:.0f}" y="20" text-anchor="middle" font-size="14">{title}</text>'
        f'<rect x="{pad}" y="{pad}" width="{width-2*pad}" height="{height-2*pad}" '
        f'fill="none" stroke="#ccc"/>'
        f'<polyline fill="none" stroke="#1f77b4" stroke-width="1.5" points="{path}"/>'
        + "".join(ticks)
        + "</svg>"
    )


def export_training_curves(
    scalars: Mapping[str, List[Tuple[int, float]]],
    out_dir: str,
) -> List[str]:
    """Write the reference's nine SVG charts from recorded scalar history.

    Args:
      scalars: tag -> [(step, value)] history (e.g. from TensorBoard event
        files or the null writer's in-memory record).
    Returns the written file paths.
    """
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for chart_name, tag in PUBLISHED_CHARTS.items():
        series = scalars.get(tag)
        if not series:
            continue
        svg = _svg_line_chart([(float(s), float(v)) for s, v in series], chart_name)
        path = os.path.join(out_dir, f"{chart_name}.svg")
        with open(path, "w") as f:
            f.write(svg)
        written.append(path)
    return written


def _read_scalars_file(path: str) -> Dict[str, List[Tuple[int, float]]]:
    out: Dict[str, List[Tuple[int, float]]] = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                out.setdefault(rec["tag"], []).append((int(rec["step"]), float(rec["value"])))
    return out


def scalars_from_tensorboard_logs(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """Read scalar history back from a run's `tensorboard_logs` directory:
    from TensorBoard event files where there are some and `tensorboard` is
    importable, else from the scalar sink's JSON lines (`obs/tb.py`), else
    {}. Event files with no `tensorboard` to read them and no JSON lines
    raise ImportError."""
    events = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    sink = os.path.join(log_dir, SCALARS_FILE)
    if events and importlib.util.find_spec("tensorboard") is not None:
        return _scalars_from_events(log_dir)
    if os.path.exists(sink):
        return _read_scalars_file(sink)
    if events:
        return _scalars_from_events(log_dir)  # ImportError: no tensorboard to read them
    return {}


def _scalars_from_events(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir)
    acc.Reload()
    out: Dict[str, List[Tuple[int, float]]] = {}
    for tag in acc.Tags().get("scalars", []):
        out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out
