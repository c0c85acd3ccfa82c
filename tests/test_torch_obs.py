"""The port's spans, sample counters and step timer (`obs/profiler.py`) on
the CPU: off without a profiler, the frame's and the trainer's spans nested
under one, the plain path's sample counts, and `StepTimer`'s host-clock
phases."""

import contextlib
import dataclasses
import json
import os
import time

import pytest
import torch

from nerf_workspaces_explorer_tpu_torch.app import workspace as ws
from nerf_workspaces_explorer_tpu_torch.core.config import (
    FrameworkConfig,
    LoggingConfig,
    ModelConfig,
    RenderingConfig,
    TrainingConfig,
    load_config,
)
from nerf_workspaces_explorer_tpu_torch.data import synthetic
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
from nerf_workspaces_explorer_tpu_torch.obs import profiler
from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
H, W = 8, 16
CLICK = (0.35, 0.55, 30, -10)
FRAME_SPANS = {"app.render_image", "renderer.frame", "renderer.rays", "fused.prepare", "fused.density",
               "fused.placement", "fused.fine", "fused.finish", "renderer.to_host"}
FUSED_ORDER = ["fused.prepare", "fused.density", "fused.placement", "fused.fine", "fused.finish"]


@pytest.fixture(scope="module")
def workspace():
    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(cfg.experiment, image_width=W, image_height=H))
    renderer = NeRFRenderer("tokyo", CKPT, config=cfg, precision="fast", device="cpu")
    renderer.initialize_models()
    return ws.OfficeTokyoWorkspace(renderer=renderer)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


def _spans(prof, tmp_path):
    """The profile's spans [(name, start, end)], by start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation"), key=lambda s: s[1])


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_span_is_off_without_a_profiler(workspace, monkeypatch, capsys):
    """No profiler: a frame renders without calling `record_function`, and
    `span` hands out one shared no-op context."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiler.tracing()
    assert profiler.span("a") is profiler.span("b")
    frame = workspace.render_image(*CLICK)
    assert frame.shape == (H, W, 3)
    assert profiler.read_counters() == {}


def test_frame_spans_nest_under_a_profiler(workspace, tmp_path, capsys):
    """Under `torch.profiler.profile()` a click yields every frame span
    once: the click holds the frame and its copy to the host, the frame
    holds the rays and the fused path's five stages, in order."""
    with torch.profiler.profile() as prof:
        assert profiler.tracing()
        workspace.render_image(*CLICK)
    spans = _spans(prof, tmp_path)
    assert {s[0] for s in spans} == FRAME_SPANS
    click, frame, to_host = (_one(spans, n) for n in ("app.render_image", "renderer.frame", "renderer.to_host"))
    assert _inside(frame, click) and _inside(to_host, click) and frame[2] <= to_host[1]
    stages = [_one(spans, n) for n in ["renderer.rays"] + FUSED_ORDER]
    assert all(_inside(s, frame) for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("traced", [True, False], ids=["profiler", "no-profiler"])
def test_plain_path_counts_every_sample_while_tracing(workspace, traced, capsys):
    """The plain passes evaluate every sample: R x S of each pass while a
    profiler records (64 coarse, 64 + 128 merged fine), nothing without; a
    traced single frame on the CPU counts as an eager one."""
    renderer = workspace.renderer
    with torch.profiler.profile() if traced else contextlib.nullcontext():
        renderer.render_pose_uint8(torch.eye(4).numpy())
    counts = profiler.read_counters()
    if traced:
        assert counts == {"render.density_samples": H * W * 64, "render.fine_samples": H * W * (64 + 128),
                          "render.eager_frames": 1}
    else:
        assert counts == {}


def test_counters_read_scale_and_reset():
    """A device counter counts in units of its scale, a host counter adds,
    and `reset_counters` clears both."""
    c = profiler.device_counter("test.steps", torch.device("cpu"), 128)
    assert profiler.device_counter("test.steps", torch.device("cpu")) is c
    c += 3
    profiler.count("test.steps", 5)
    profiler.count("test.host", 7)
    assert profiler.read_counters() == {"test.steps": 3 * 128 + 5, "test.host": 7}
    profiler.reset_counters()
    assert profiler.read_counters() == {}
    assert profiler.device_counter("test.steps", torch.device("cpu")) is not c


def _graph_replay(counters, added):
    def launch():  # a graph's kernels adding to the counters it captured
        counters.values.add_(torch.tensor(added, dtype=torch.int32))
    return counters.replay(launch)


def test_graph_counters_count_runs_of_traced_replays():
    """`GraphCounters` count, times the scale, what the graph adds while
    tracing: untraced replays before, between and after two profiler
    sessions count nothing, and a run of traced replays keeps one pair of
    copies however long it is."""
    counters = profiler.GraphCounters(("test.a", "test.b"), torch.device("cpu"), 128)
    _graph_replay(counters, [100, 100])
    with torch.profiler.profile():
        for added in ([1, 2], [3, 4], [5, 6]):
            _graph_replay(counters, added)
    _graph_replay(counters, [1000, 1000])
    with torch.profiler.profile():
        _graph_replay(counters, [7, 8])
    _graph_replay(counters, [1000, 1000])
    assert len(profiler._GRAPH_RUNS) == 2
    assert profiler.read_counters() == {"test.a": 16 * 128, "test.b": 20 * 128}
    profiler.reset_counters()
    assert profiler.read_counters() == {}


def test_graph_counters_start_a_run_after_a_reset():
    """`reset_counters` inside a run of traced replays drops what it
    counted; the next traced replay starts a new run from there."""
    counters = profiler.GraphCounters(("test.a",), torch.device("cpu"))
    with torch.profiler.profile():
        _graph_replay(counters, [5])
        profiler.reset_counters()
        _graph_replay(counters, [3])
        _graph_replay(counters, [4])
    assert profiler.read_counters() == {"test.a": 7}
    profiler.reset_counters()


def test_graph_counters_read_across_the_int32_wrap():
    """The graph never resets its counters, which wrap around int32: a run
    reads their difference modulo 2**32."""
    counters = profiler.GraphCounters(("test.a",), torch.device("cpu"))
    counters.values.fill_(2**31 - 10)
    with torch.profiler.profile():
        _graph_replay(counters, [20])
    assert int(counters.values) == -(2**31) + 10
    assert profiler.read_counters() == {"test.a": 20}
    profiler.reset_counters()


def test_step_timer_on_the_cpu(tmp_path):
    """On the CPU a phase is timed by the host clock: totals, counts, means
    and the summary by phase; with a span name the phase is that span."""
    timer = profiler.StepTimer(torch.device("cpu"))
    with timer.phase("a"):
        time.sleep(0.01)
    with timer.phase("a"):
        pass
    with torch.profiler.profile() as prof:
        with timer.phase("b", "test.b"):
            pass
    assert timer.counts == {"a": 2, "b": 1}
    assert timer.totals["a"] >= 0.01
    assert timer.mean("a") == pytest.approx(timer.totals["a"] / 2)
    assert set(timer.summary()) == {"a", "b"}
    assert [s[0] for s in _spans(prof, tmp_path)] == ["test.b"]
    timer.reset()
    assert not timer.totals and not timer.counts and timer.summary() == {}


def _tiny_trainer(tmp_path, **kwargs):
    train, test, _ = synthetic.make_synthetic_scene(n_train=2, n_test=1, height=12, width=16)
    cfg = FrameworkConfig(
        training=TrainingConfig(learning_rate=5e-3),
        model=ModelConfig(net_depth=4, net_width=64, chunk=4096),
        rendering=RenderingConfig(n_rays=64, n_samples=8, n_importance=8, num_freqs_3d=6, num_freqs_2d=2,
                                  raw_noise_std=1.0, depth_range=(0.1, 6.0)),
        logging=LoggingConfig(step_log_print=0, step_log_tensorboard=20, step_save_ckpt=0, step_render_test=0,
                              step_render_train=0),
    )
    tr = Trainer("office_tokyo", cfg, train_data=train, test_data=test, save_dir=str(tmp_path / "run"),
                 enable_tensorboard=False, device="cpu", **kwargs)
    tr.setup()
    return tr


def test_trainer_spans_and_phase(tmp_path):
    """`step_many` and `step` are the spans `train.step_many` and
    `train.step`, each holding its draws and its eager steps, and each a
    call of the `train_step` phase; an eval render is `train.render_test`."""
    tr = _tiny_trainer(tmp_path, steps_per_call=2)
    with torch.profiler.profile() as prof:
        tr.step_many(0)
        tr.step(2)
        tr.render_test_images(3)
    spans = _spans(prof, tmp_path)
    assert [s[0] for s in spans if s[0] in ("train.step_many", "train.step", "train.render_test")] == [
        "train.step_many", "train.step", "train.render_test"]
    for call in ("train.step_many", "train.step"):
        outer = _one(spans, call)
        inner = [s[0] for s in spans if _inside(s, outer) and s is not outer and s[0].startswith("train.")]
        assert inner == ["train.draws", "train.eager"], (call, inner)
    assert tr.timer.counts["train_step"] == 2 and tr.timer.counts["render_test"] == 1
    assert set(tr.timer.summary()) == {"train_step", "render_test"}
