"""The benchmark's tests: `python -m pytest benchmark/tests -q` on the CPU;
on the card, `python -m pytest benchmark/tests -q -m gpu` (marked `gpu`,
skipped without one)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
