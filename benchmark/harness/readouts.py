"""What the metric readers read: each `metrics/<metric>.py` names one of
these and its unit. `ctx` is the run's context (`harness/frames.py`,
`harness/steps.py`): the window, `setup_s`, the reduced trace or None, the
reference's sample counts of the traced frames (`counts`), the calls'
`steps_per_call`, `config` and `mix`. A reader with nothing to read
returns None, and the run leaves its metric out."""

from __future__ import annotations

import numpy as np

from harness import counts, trace

K5 = ("field_bwd_chain_kernel", "field_dw_kernel", "sum_rows_kernel")


def setup_s(ctx):
    """From the start of the process to the first timed unit of work."""
    return ctx["setup_s"]


def frame_ms(ctx):
    """The window's host-clock seconds over the frames served in it."""
    win = ctx["window"]
    return win.seconds / len(win.requests) * 1e3 if win.requests else None


def frame_ms_p95(ctx):
    """The 95th percentile of every frame's host-clock latency in the window
    (numpy's linear interpolation between order statistics)."""
    lat = ctx["window"].latencies_s
    return float(np.percentile(np.asarray(lat) * 1e3, 95.0)) if lat else None


def step_ms(ctx):
    """The window's host-clock seconds, ended by a synchronize, over the
    optimizer steps its calls took."""
    win = ctx["window"]
    return win.seconds / win.steps * 1e3 if win.steps else None


def _traced_steps(ctx) -> int:
    return len(ctx["trace"].units) * ctx["steps_per_call"]


def _untraced_step_s(ctx):
    """Host-clock seconds a step of the calls after the traced span."""
    win = ctx["window"]
    return win.tail_seconds / win.tail_steps if win.tail_steps else None


def idle_share_frames(ctx):
    """1 - the union of the device operations' intervals over the traced
    frames' span, in percent."""
    tr = ctx["trace"]
    if tr is None or trace.window_s(tr) <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / trace.window_s(tr))


def idle_share_steps(ctx):
    """1 - the device's busy time a traced step (the union of its
    operations' intervals) over the host-clock time a step of the untraced
    calls after them, in percent: the profiler's own host work lengthens
    the traced steps, not the device's."""
    tr = ctx["trace"]
    step_s = _untraced_step_s(ctx)
    if tr is None or not tr.units or not step_s:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / _traced_steps(ctx) / step_s)


def kernels_per_frame(ctx):
    """Device kernels a traced frame (graph replays included, copies and
    sets not)."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    return len(trace.kernels(tr)) / len(tr.units)


def kernels_per_step(ctx):
    """Device kernels a traced step (graph replays included, copies and
    sets not)."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    return len(trace.kernels(tr)) / _traced_steps(ctx)


def _full_pass(op) -> bool:
    args = trace.template_args(op.name)
    return op.name.startswith("render_kernel<") and bool(args) and args[-1] == "false"


def fine_pass_roofline(ctx):
    """The least time the card could take for the fine pass of the traced
    frames, from the samples their inputs need (the reference's count of
    the fine samples before transmittance falls below the configuration's
    eps) and the fine net's shapes, over the traced time of the render
    kernel's full passes (`render_kernel<..., false>`), in percent."""
    tr = ctx["trace"]
    if tr is None or not ctx["counts"]:
        return None
    kernel_s = sum(op.dur_us for op in trace.kernels(tr) if _full_pass(op)) * 1e-6
    if kernel_s <= 0:
        return None
    fine = ctx["config"]["nets"]["fine"]
    ref = ctx["config"]["reference"]
    per_ray = int(ref["n_importance"]) + (int(ref["n_samples"]) if ref["merge"] else 0)
    bound = sum(counts.bound_s(counts.pass_flops(fine, c.fine_needed, c.fine_rays, True),
                               counts.fine_pass_bytes(fine, per_ray, c.fine_rays))[0] for c in ctx["counts"])
    return 100.0 * bound / kernel_s


def mfu_frames(ctx):
    """The operations the traced frames' inputs need (density and fine
    pass, each over the samples before transmittance falls below eps) over
    their host-clock span in the trace times the dense bf16 peak, in
    percent."""
    tr = ctx["trace"]
    if tr is None or not ctx["counts"]:
        return None
    wall = sum(d for _, d in tr.units) * 1e-6
    nets = ctx["config"]["nets"]
    dens = nets[ctx["config"]["reference"]["density_net"]]
    flops = sum(counts.pass_flops(dens, c.density_needed, c.density_rays, False)
                + counts.pass_flops(nets["fine"], c.fine_needed, c.fine_rays, True) for c in ctx["counts"])
    return 100.0 * flops / (wall * counts.PEAK_BF16_FLOPS)


def field_fwd_roofline(ctx):
    """The least time for a step's forward of both nets over every sample,
    times the traced steps, over the traced time of `field_fwd_kernel`
    (K4), in percent."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    t = trace.kernel_s(tr, ("field_fwd_kernel",))
    if t <= 0:
        return None
    return 100.0 * counts.bound_s(counts.train_forward_flops(ctx["config"]), 0)[0] * _traced_steps(ctx) / t


def field_bwd_roofline(ctx):
    """The least time for the backward's own products, twice the forward's
    operations (K5's recomputation and scratch belong to its design), times
    the traced steps, over the summed traced time of K5's kernels, in
    percent."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    t = trace.kernel_s(tr, K5)
    if t <= 0:
        return None
    return 100.0 * counts.bound_s(2.0 * counts.train_forward_flops(ctx["config"]), 0)[0] * _traced_steps(ctx) / t


def mfu_steps(ctx):
    """Three times a step's forward operations of both nets (the forward,
    and a backward of twice its products) over the host-clock time a step
    of the untraced calls after the traced span, times the dense bf16 peak,
    in percent. Read in a traced run, off its traced span's overhead."""
    step_s = _untraced_step_s(ctx)
    if ctx["trace"] is None or not step_s:
        return None
    return 100.0 * 3.0 * counts.train_forward_flops(ctx["config"]) / (step_s * counts.PEAK_BF16_FLOPS)
