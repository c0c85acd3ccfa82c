"""What the program's own spans and counters say about a traced run.

The program (`nerf_workspaces_explorer_tpu_torch/obs/profiler.py`) marks
its stages with `record_function` spans while a `torch.profiler` session
records, and counts the samples its render passes evaluate; both exist
only in a traced run. A span is a host event of the reduced trace (`name,
start, duration`, us) inside one of the benchmark's units. A program
without a span or counter a reader needs makes that reader return None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from harness import trace

DENSITY_SAMPLES = "render.density_samples"
FINE_SAMPLES = "render.fine_samples"


def unit_spans(tr: trace.Trace, name: str) -> List[List[Tuple[float, float]]]:
    """For each traced unit, the (start, end) of the spans named `name`
    that lie inside it, us."""
    found = [(hs, hs + hd) for n, hs, hd in tr.host_ops if n == name]
    return [[(s, e) for s, e in found if us <= s and e <= us + ud] for us, ud in tr.units]


def program_counters() -> Optional[Dict[str, int]]:
    """The program's counters after the run (`obs.profiler.read_counters`),
    or None where the program has none."""
    from nerf_workspaces_explorer_tpu_torch.obs import profiler

    read = getattr(profiler, "read_counters", None)
    return read() if read is not None else None


def prep_ms(ctx):
    """Host milliseconds a traced frame from the start of its first
    `renderer.frame` span to the end of its last `fused.fine` span: the
    frame's host work until its fine pass is queued, over the units that
    hold both."""
    tr = ctx["trace"]
    if tr is None:
        return None
    per = [max(e for _, e in fine) - min(s for s, _ in frame)
           for frame, fine in zip(unit_spans(tr, "renderer.frame"), unit_spans(tr, "fused.fine")) if frame and fine]
    return sum(per) / len(per) * 1e-3 if per else None


def step_host_ms(ctx):
    """Host milliseconds of the traced `train.step_many` spans (a call's
    draws, input copies and graph launch, up to its return) over the
    traced steps."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    host_us = sum(e - s for unit in unit_spans(tr, "train.step_many") for s, e in unit)
    if host_us <= 0:
        return None
    return host_us * 1e-3 / (len(tr.units) * ctx["steps_per_call"])


def _evaluated_per_needed(ctx, counter: str, needed_field: str):
    if ctx["trace"] is None or not ctx.get("counts"):
        return None
    counts = program_counters()
    needed = sum(getattr(c, needed_field) for c in ctx["counts"])
    if not counts or counts.get(counter, 0) <= 0 or needed <= 0:
        return None
    return counts[counter] / needed


def fine_evaluated_per_needed(ctx):
    """The fine-pass samples the program evaluated over the traced frames
    (`render.fine_samples`: its kernels' 4-sample steps of 32-ray blocks)
    over the samples their inputs need (the reference's count before
    transmittance falls below the configuration's eps)."""
    return _evaluated_per_needed(ctx, FINE_SAMPLES, "fine_needed")


def density_evaluated_per_needed(ctx):
    """As `fine_evaluated_per_needed`, for the density pass
    (`render.density_samples` over the reference's `density_needed`)."""
    return _evaluated_per_needed(ctx, DENSITY_SAMPLES, "density_needed")
