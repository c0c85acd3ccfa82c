"""Host milliseconds a traced frame of the walk cells spends from the start
of the program's `renderer.frame` span to the end of its `fused.fine` span:
until the fine pass is queued."""

from harness import spans

UNIT = "ms"
read = spans.prep_ms
