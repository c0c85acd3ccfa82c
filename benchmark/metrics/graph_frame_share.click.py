"""The share of the traced frames of the click cells that the program served
as replays of its frame graph: its `render.graph_replays` counter over
that plus `render.eager_frames`, in percent. None where the program has
neither counter."""

from harness import spans

UNIT = "%"
REPLAYS = "render.graph_replays"
EAGER = "render.eager_frames"


def read(ctx):
    if ctx["trace"] is None:
        return None
    counts = spans.program_counters() or {}
    replays, eager = counts.get(REPLAYS, 0), counts.get(EAGER, 0)
    if replays + eager <= 0:
        return None
    return 100.0 * replays / (replays + eager)
