"""Host milliseconds a traced step of the graph cells spends in the
program's `train.step_many` spans (draws, input copies, graph launch), over
the traced steps."""

from harness import spans

UNIT = "ms"
read = spans.step_host_ms
