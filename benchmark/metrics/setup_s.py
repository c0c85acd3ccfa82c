"""Set-up: from the start of the process to the first timed request or call
(interpreter and PyTorch start, CUDA's context, the kernels' libraries
loaded, and built where the checkout has none yet, weights or data made and
loaded, the warm-up requests or the judged calls)."""

from harness import readouts

UNIT = "s"
read = readouts.setup_s
