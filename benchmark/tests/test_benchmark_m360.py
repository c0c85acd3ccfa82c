"""The mip-NeRF 360 cell end to end on the CPU at a tiny size: the
configuration's checkpoint cut to nets of 8x64 and 4x32 (every other
setting as published), a 16x12 frame. Sound, a whole run comes out
correct; with half of each frame's rays left black where the program
composites them, with each request answered by the frame of the one
before, or with the float8 control's frames judged in its place, it does
not. The seeded draw is bit-equal between the program and
the reference, and the per-layer readers read a reduced trace."""

import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

from harness import counts_m360, faults, frames_m360, manifest, readouts_m360, trace
from reference import mipnerf360 as ref

MAN = manifest.manifest()
NAME = "m360-click-320"
SMALL = dict(nerf_width=64, prop_width=32, bottleneck=32, view_width=16)


def _checkpoint(tmp_path):
    with open(os.path.join(manifest.ROOT, "assets", "bench", "mipnerf360_seeded.json")) as f:
        meta = json.load(f)
    meta["spec"].update(SMALL)
    path = tmp_path / "m360_small.json"
    path.write_text(json.dumps(meta))
    return str(path)


def _run(tmp_path, fault=None, control=False):
    entry = manifest.workload_entry(MAN, NAME)
    config = manifest.load_config(MAN, entry["config"])
    ckpt = _checkpoint(tmp_path)
    config = dict(config, serve=dict(config["serve"], checkpoint=ckpt), reference=dict(config["reference"], weights=ckpt))
    mix = dict(manifest.load_traffic(entry["traffic"]), height=12, width=16)
    cell = manifest.load_cell(NAME)
    cell = dict(cell, trace={"start": 1, "units": 2}, check=dict(cell["check"], frames=3, pixels=96))
    gen = manifest.generator(mix["kind"])
    serve = faults.stale_answer(gen.serve) if fault == "stale_answer" else gen.serve
    torch.set_num_threads(4)
    with frames_m360.FAULTS[fault]() if fault in frames_m360.FAULTS else contextlib.nullcontext():
        return frames_m360.run_cell(entry, config, mix, cell, gen, {}, seed=2**31 + 77, seconds=2.0, trace=False,
                                    device="cpu", t_start=time.perf_counter(), serve=serve,
                                    control=control)


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["checks"], "the cell compares no number"
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["half_rays", "stale_answer"])
def test_broken_run_is_not_correct(tmp_path, fault):
    out = _run(tmp_path, fault)
    assert not out["correct"], out["checks"]


def test_float8_control_is_not_correct(tmp_path):
    """The control's frames, the reference with every product's operands
    rounded to float8 e4m3, through the cell's judge and limits."""
    out = _run(tmp_path, control=True)
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_seeded_draw_matches_the_program():
    from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_seeded_checkpoint

    path = os.path.join(manifest.ROOT, "assets", "bench", "mipnerf360_seeded.json")
    tree, spec, _ = load_seeded_checkpoint(path)
    params, ref_spec = ref.load(path, "cpu")
    assert ref_spec == spec.to_dict()
    for net, layers in tree.items():
        named = {f"trunk{i}": l for i, l in enumerate(layers["trunk"])}
        named.update({k: v for k, v in layers.items() if k != "trunk"})
        assert sorted(named) == sorted(params[net])
        for k, leaf in named.items():
            assert np.array_equal(leaf["w"], params[net][k][0].numpy()), (net, k)
            assert np.array_equal(leaf["b"], params[net][k][1].numpy()), (net, k)


def _trace(kernels, spans):
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.UNIT_SPAN, "ts": 0.0, "dur": 100000.0}]
    events += [{"ph": "X", "cat": "kernel", "name": f"void (anonymous namespace)::{k}(LinArgs)", "ts": 10.0 + i,
                "dur": d} for i, (k, d) in enumerate(kernels)]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": 20.0 + i, "dur": d} for i, (n, d) in enumerate(spans)]
    return trace.reduce_events(events)


def test_readers_split_the_two_mlps_and_read_placement():
    config = manifest.load_config(MAN, "mipnerf360-8x1024")
    spec = counts_m360.spec_of(config)
    tr = _trace([("linear_kernel<256, 5, 8>", 4000.0), ("linear_kernel<256, 2, 4>", 9000.0),
                 ("linear_kernel<256, 0, 16>", 50000.0), ("linear_kernel<128, 4, 4>", 2000.0)],
                [("m360.placement", 300.0), ("m360.placement", 200.0)])
    ctx = dict(trace=tr, counts=[dict(rays=76800)], config=config)
    nerf = readouts_m360.nerf_mlp_roofline(ctx)
    prop = readouts_m360.prop_mlp_roofline(ctx)
    assert nerf == pytest.approx(100 * counts_m360.pass_bound_s(spec, "nerf", 76800) / 52e-3)
    assert prop == pytest.approx(100 * counts_m360.pass_bound_s(spec, "prop", 76800) / 4e-3)
    assert readouts_m360.placement_ms(ctx) == pytest.approx(0.5)
    # 87% of the frame's operations are the NeRF MLP's (the configuration's claim)
    share = counts_m360.nerf_flops(spec, 1) / (counts_m360.nerf_flops(spec, 1) + counts_m360.prop_flops(spec, 1))
    assert 0.86 < share < 0.88
    empty = dict(ctx, trace=_trace([("render_kernel<256, 10, 0, false>", 10.0)], []))
    assert readouts_m360.nerf_mlp_roofline(empty) is None and readouts_m360.placement_ms(empty) is None
