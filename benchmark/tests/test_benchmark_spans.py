"""The readers of the program's spans and counters (`harness/spans.py`) on
hand-made trace events, reduced as a run reduces them."""

from typing import NamedTuple

import pytest

from harness import manifest, spans, trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _unit(ts, dur):
    return _ev("user_annotation", trace.UNIT_SPAN, ts, dur)


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


class Counts(NamedTuple):
    density_needed: int
    fine_needed: int


FRAME_EVENTS = [
    _unit(0.0, 1000.0),
    _span("app.render_image", 5.0, 990.0),
    _span("renderer.frame", 10.0, 800.0),
    _span("fused.prepare", 20.0, 100.0),
    _span("fused.fine", 500.0, 100.0),  # 10 .. 600
    _span("renderer.to_host", 820.0, 170.0),
    _ev("kernel", "render_kernel<256, 10, 0, false>(NetPtrs)", 560.0, 400.0),
    _unit(1000.0, 1000.0),
    _span("renderer.frame", 1020.0, 700.0),
    _span("fused.fine", 1300.0, 50.0),  # 1020 .. 1350
    _span("fused.fine", 1500.0, 100.0),  # a second batch: 1020 .. 1600
    _unit(2000.0, 500.0),  # a unit without the program's spans
]


def _ctx(events, **kw):
    return dict(trace=trace.reduce_events(events), **kw)


def test_prep_ms_spans_the_frame_to_its_last_fine_pass():
    assert spans.prep_ms(_ctx(FRAME_EVENTS)) == pytest.approx((590.0 + 580.0) / 2 * 1e-3)


def test_unit_spans_keep_each_unit_apart():
    tr = trace.reduce_events(FRAME_EVENTS)
    assert spans.unit_spans(tr, "fused.fine") == [[(500.0, 600.0)], [(1300.0, 1350.0), (1500.0, 1600.0)], []]


def test_step_host_ms_over_the_traced_steps():
    events = [_unit(0.0, 6000.0), _span("train.step_many", 10.0, 700.0), _span("train.draws", 20.0, 200.0),
              _unit(6000.0, 6000.0), _span("train.step_many", 6010.0, 900.0),
              _ev("kernel", "field_fwd_kernel", 800.0, 5000.0)]
    assert spans.step_host_ms(_ctx(events, steps_per_call=10)) == pytest.approx(1600.0 / 20 * 1e-3)


@pytest.mark.parametrize("reader", [spans.prep_ms, spans.step_host_ms, spans.fine_evaluated_per_needed,
                                    spans.density_evaluated_per_needed])
def test_readers_without_the_programs_spans_or_counters_return_none(reader, monkeypatch):
    """A trace holding only the benchmark's units and kernels, and a program
    without counters (the state before the program had them), read None;
    so does an untraced run."""
    monkeypatch.setattr(spans, "program_counters", lambda: None)
    events = [_unit(0.0, 100.0), _ev("kernel", "render_kernel<256, 10, 0, false>(NetPtrs)", 10.0, 50.0),
              _ev("cpu_op", "aten::copy_", 70.0, 20.0)]
    counts = [Counts(100, 300)]
    assert reader(_ctx(events, steps_per_call=10, counts=counts)) is None
    assert reader(dict(trace=None, steps_per_call=10, counts=counts)) is None


def test_evaluated_per_needed_divides_the_counters_by_the_needed_samples(monkeypatch):
    monkeypatch.setattr(spans, "program_counters",
                        lambda: {spans.FINE_SAMPLES: 1280, spans.DENSITY_SAMPLES: 512})
    ctx = _ctx(FRAME_EVENTS, counts=[Counts(100, 300), Counts(156, 340)])
    assert spans.fine_evaluated_per_needed(ctx) == pytest.approx(1280 / 640)
    assert spans.density_evaluated_per_needed(ctx) == pytest.approx(512 / 256)
    assert spans.fine_evaluated_per_needed(dict(ctx, counts=[])) is None


def test_program_counters_are_the_programs():
    """The port's counters, read after no traced work: none counted."""
    pytest.importorskip("torch")
    from nerf_workspaces_explorer_tpu_torch.obs import profiler

    profiler.reset_counters()
    assert spans.program_counters() == {}


def test_new_readers_are_listed_with_their_units():
    man = manifest.manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name, unit, source in [("fine_evaluated_per_needed.click", "x", "program_counter"),
                               ("fine_evaluated_per_needed.walk", "x", "program_counter"),
                               ("density_evaluated_per_needed.click", "x", "program_counter"),
                               ("prep_ms.click", "ms", "program_span"), ("prep_ms.walk", "ms", "program_span"),
                               ("step_host_ms.graph", "ms", "program_span")]:
        assert entries[name]["unit"] == unit and entries[name]["source"] == source
        reader = manifest.metric_reader(name)
        assert reader.UNIT == unit and reader.read.__module__ == spans.__name__
