"""The benchmark's files, found by name.

`BENCHMARK.json` at the repository's root lists the configurations, cells
and metrics. Everything that belongs to one of them is a file of its own:

- `configs/<config>.json`: a configuration's sizes (the entry's `file`);
- `traffic/<traffic>.json`: a traffic mix's parameters, whose `kind` names
  the generator `generators/<kind>.py` that reads them;
- `workloads/<cell>.json`: what a cell checks (its sample and limits) and
  how much of its window a traced run profiles;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def workload_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(w['name'] for w in man['workloads'])})")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(man: dict, name: str, root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, config_entry(man, name)["file"]))


def load_traffic(name: str) -> dict:
    return _read_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def load_cell(name: str) -> dict:
    return _read_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str) -> ModuleType:
    return _module(os.path.join(BENCH_DIR, "generators", f"{kind}.py"), f"bench_generator_{kind}")


def metric_reader(name: str) -> ModuleType:
    return _module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"), "bench_metric_" + name.replace(".", "_"))


def metrics_of(man: dict, section: str, workload: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that the cell
    reports: those listing it under `workloads`, and end-to-end ones
    without the key (`setup_s`), which every cell reports."""
    return [m for m in man[section] if workload in m.get("workloads", [workload] if section == "end_to_end" else [])]
