"""The fine-pass samples the program evaluated over the traced frames of the
click cells (its `render.fine_samples` counter) over the samples their
inputs need (the reference's count)."""

from harness import spans

UNIT = "x"
read = spans.fine_evaluated_per_needed
