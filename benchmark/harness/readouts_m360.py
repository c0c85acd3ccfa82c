"""What the mip-NeRF 360 cells' per-layer metrics read (`harness/readouts.py`'s
conventions): a reader with nothing to read returns None."""

from __future__ import annotations

from harness import counts, counts_m360, spans


def _rays(ctx) -> int:
    return sum(int(c["rays"]) for c in ctx.get("counts") or [])


def mfu(ctx):
    """The operations the traced frames need (both proposal rounds and the
    NeRF MLP over every sample) over their host-clock span in the trace
    times the dense bf16 peak, in percent."""
    tr = ctx["trace"]
    if tr is None or not tr.units or not _rays(ctx):
        return None
    spec = counts_m360.spec_of(ctx["config"])
    flops = counts_m360.prop_flops(spec, _rays(ctx)) + counts_m360.nerf_flops(spec, _rays(ctx))
    wall = sum(d for _, d in tr.units) * 1e-6
    return 100.0 * flops / (wall * counts.PEAK_BF16_FLOPS)


def _roofline(ctx, net: str):
    tr = ctx["trace"]
    if tr is None or not _rays(ctx):
        return None
    t = counts_m360.kernel_s(tr, net)
    if t <= 0:
        return None
    return 100.0 * counts_m360.pass_bound_s(counts_m360.spec_of(ctx["config"]), net, _rays(ctx)) / t


def nerf_mlp_roofline(ctx):
    """The NeRF MLP's least time over the traced frames' rays over the traced
    time of its K11 launches, in percent."""
    return _roofline(ctx, "nerf")


def prop_mlp_roofline(ctx):
    """The same for the proposal MLP's two rounds."""
    return _roofline(ctx, "prop")


def placement_ms(ctx):
    """Host milliseconds a traced frame spends in the program's
    `m360.placement` spans."""
    tr = ctx["trace"]
    if tr is None or not tr.units:
        return None
    per = spans.unit_spans(tr, "m360.placement")
    if not any(per):
        return None
    return sum(e - s for unit in per for s, e in unit) * 1e-3 / len(tr.units)
