"""A `torch.profiler` trace reduced to what the per-layer metrics read.

The profiler's Chrome trace holds host events (operators, CUDA runtime
calls, the benchmark's own `record_function` spans) and device events
(kernels, copies, sets) on one clock. The window is the span from the
first to the last unit of work the benchmark marked (`UNIT_SPAN`). Busy
time is the union of the device events' intervals inside it, so kernels
that overlap on two streams count once; the idle share is the rest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

UNIT_SPAN = "bench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start_us: float
    dur_us: float


class Trace(NamedTuple):
    units: List[Tuple[float, float]]  # (start, duration) of each marked unit, us
    window_us: Tuple[float, float]
    device_ops: List[DeviceOp]  # inside the window
    host_ops: List[Tuple[str, float, float]]  # (name, start, duration), inside the window


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces and parameters,
    template arguments kept: "void (anonymous namespace)::render_kernel<256,
    10, 0, false>(NetPtrs, ...)" -> "render_kernel<256, 10, 0, false>"."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    head, sep, rest = name.partition("<")
    return head.split("::")[-1] + sep + rest


def template_args(name: str) -> List[str]:
    """The top-level template arguments of a short kernel name."""
    _, sep, rest = name.partition("<")
    if not sep:
        return []
    args, depth, cur = [], 0, ""
    for ch in rest[:-1]:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return args + [cur.strip()]


def read_profile(prof) -> Trace:
    """Export a finished profile to a temporary file under TMPDIR, read it
    back and delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events)


def reduce_events(events: list) -> Trace:
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    units = sorted((float(e["ts"]), float(e["dur"])) for e in complete
                   if e.get("cat") == "user_annotation" and e.get("name") == UNIT_SPAN)
    if not units:
        raise ValueError(f"the trace holds no {UNIT_SPAN} span")
    lo, hi = units[0][0], max(s + d for s, d in units)
    device, host = [], []
    for e in complete:
        ts, dur, cat = float(e["ts"]), float(e["dur"]), e.get("cat")
        if ts + dur <= lo or ts >= hi:
            continue
        if cat in DEVICE_CATS:
            device.append(DeviceOp(short_name(e["name"]) if cat == "kernel" else cat, cat, ts, dur))
        elif cat in HOST_CATS and e.get("name") != UNIT_SPAN:
            host.append((e["name"], ts, dur))
    device.sort(key=lambda op: op.start_us)
    return Trace(units, (lo, hi), device, host)


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, clipped to the window."""
    lo, hi = trace.window_us
    merged: List[List[float]] = []
    for op in trace.device_ops:
        s, e = max(op.start_us, lo), min(op.start_us + op.dur_us, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) * 1e-6


def window_s(trace: Trace) -> float:
    return (trace.window_us[1] - trace.window_us[0]) * 1e-6


def kernels(trace: Trace) -> List[DeviceOp]:
    return [op for op in trace.device_ops if op.cat == "kernel"]


def kernel_s(trace: Trace, names) -> float:
    """Seconds of the kernels whose name, template arguments aside, is one of `names`."""
    return sum(op.dur_us for op in kernels(trace) if op.name.split("<")[0] in names) * 1e-6


def top_device_ops(trace: Trace, n: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    tot: Dict[str, float] = defaultdict(float)
    for op in trace.device_ops:
        tot[op.name[:120]] += op.dur_us * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> List[list]:
    """[host activity, seconds]: the device's idle time inside the window,
    summed by what the host was doing at the middle of each gap (the
    latest-starting host event that covers it, which for nested events is
    the innermost; "host python" where none does)."""
    lo, hi = trace.window_us
    edges = [lo] + [x for iv in busy_intervals(trace) for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = sorted(trace.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    tot: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = "host python"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            name, hs, hd = host[i]
            if hs + hd >= mid:
                label = name[:120]
                break
            i -= 1
        tot[label] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
