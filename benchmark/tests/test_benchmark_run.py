"""run.py refuses to run without a card, and the trace reduction's
arithmetic."""

import json
import os
import subprocess
import sys

import pytest

from harness import manifest, trace


def test_run_fails_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    name = manifest.manifest()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"), "--workload", name, "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 2
    assert "no CUDA card" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_union_idle_gaps_and_names():
    events = [
        _ev("user_annotation", trace.UNIT_SPAN, 0.0, 100.0),
        _ev("user_annotation", trace.UNIT_SPAN, 100.0, 100.0),
        _ev("kernel", "void (anonymous namespace)::render_kernel<256, 10, 0, false>(NetPtrs, int)", 10.0, 50.0),
        _ev("kernel", "void at::native::foo<float>(int)", 40.0, 40.0),  # overlaps the first: counts once
        _ev("gpu_memcpy", "Memcpy DtoH", 150.0, 10.0),
        _ev("kernel", "outside", 500.0, 10.0),
        _ev("cpu_op", "aten::copy_", 85.0, 30.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 170.0, 25.0),
    ]
    tr = trace.reduce_events(events)
    assert tr.window_us == (0.0, 200.0)
    assert trace.busy_intervals(tr) == [(10.0, 80.0), (150.0, 160.0)]
    assert trace.busy_s(tr) == pytest.approx(80e-6)
    assert trace.window_s(tr) == pytest.approx(200e-6)
    assert [op.name for op in trace.kernels(tr)] == ["render_kernel<256, 10, 0, false>", "foo<float>"]
    assert trace.template_args("render_kernel<256, 10, 0, false>") == ["256", "10", "0", "false"]
    gaps = dict(trace.idle_gaps(tr))
    assert gaps["aten::copy_"] == pytest.approx(70e-6)  # 80..150
    assert gaps["cudaStreamSynchronize"] == pytest.approx(40e-6)  # 160..200
    assert gaps["host python"] == pytest.approx(10e-6)  # 0..10
    assert trace.top_device_ops(tr)[0] == ["render_kernel<256, 10, 0, false>", pytest.approx(50e-6)]
