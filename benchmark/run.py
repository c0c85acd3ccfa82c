#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name through `BENCHMARK.json`
(`harness/manifest.py`). Set-up builds the program's system and serves the
generator's warm-up requests; the window then serves requests back to
back for `--seconds`; with `--trace 1` part of it runs under
`torch.profiler` and the line carries the cell's per-layer metrics instead
of its end-to-end ones. After the window the frames served are judged
against the plain reference (`reference/`), each number beside its limit on
standard error and under `checks` in the line. The last line of standard
output is the result, one JSON object.

Exits 2 without a result where CUDA or enough cards are missing, and 3
where the process holds JAX or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)

from harness import manifest, runtime  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # One process with one host thread for PyTorch's own CPU operators: the
    # host's Python and launches are the work, and idle threads only jitter.
    runtime.torch.set_num_threads(1)
    for key, path in runtime.cache_dirs(BENCH_DIR).items():
        os.environ[key] = path
    man = manifest.manifest()
    entry = manifest.workload_entry(man, args.workload)
    try:
        runtime.require_cards(int(entry["chips"]))
    except RuntimeError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    config = manifest.load_config(man, entry["config"])
    mix = manifest.load_traffic(entry["traffic"])
    cell = manifest.load_cell(entry["name"])
    gen = manifest.generator(mix["kind"])
    section = "per_layer" if args.trace else "end_to_end"
    readers = {m["name"]: manifest.metric_reader(m["name"]) for m in manifest.metrics_of(man, section, entry["name"])}
    driver = __import__(f"harness.{gen.DRIVER}", fromlist=["run_cell"])
    try:
        out = driver.run_cell(entry, config, mix, cell, gen, readers, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t_start=T_START)
    except runtime.ForbiddenModules as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    out["device"]["power_limit"] = runtime.card_power_limit()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
