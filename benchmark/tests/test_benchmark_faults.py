"""A whole run of each cell on the CPU, at a small size, without the look
for a card: sound, it comes out correct; with the program's timed path
broken underneath, `correct` comes out false, once for each fault the cell
can have. A frame cell: half of the frame's rays left out where the fused
path composites them; an answer altered where it is produced (the frame of
the request before). A training cell: a step that leaves the parameters as
they were; half of the batch left out of the loss, its mean taken over the
rest."""

import contextlib
import time

import pytest
import torch

from harness import faults, frames, manifest, steps

MAN = manifest.manifest()
# a frame size at which the CPU runs the plain versions of the kernels in
# about a second; the turbo cell's 4x4 placement blocks need more than 16x12
SIZES = {"hier-click-320": (12, 16), "turbo-walk-320": (48, 64)}


def _run(name, fault=None):
    entry = manifest.workload_entry(MAN, name)
    config = manifest.load_config(MAN, entry["config"])
    h, w = SIZES[name]
    mix = dict(manifest.load_traffic(entry["traffic"]), height=h, width=w)
    cell = manifest.load_cell(name)
    cell = dict(cell, trace={"start": 1, "units": 2}, check=dict(cell["check"], frames=3, pixels=96))
    gen = manifest.generator(mix["kind"])
    serve = faults.stale_answer(gen.serve) if fault == "stale_answer" else gen.serve
    torch.set_num_threads(4)
    with faults.PATCHES[fault]() if fault in faults.PATCHES else contextlib.nullcontext():
        return frames.run_cell(entry, config, mix, cell, gen, {}, seed=2**31 + 77, seconds=2.0, trace=False,
                               device="cpu", t_start=time.perf_counter(), serve=serve)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["checks"], "the cell compares no number"
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["half_rays", "stale_answer"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_broken_run_is_not_correct(name, fault):
    out = _run(name, fault)
    assert not out["correct"], out["checks"]


# the training cells at a size the CPU steps in well under a second
TRAIN_MIX = {"hier-train-k10": dict(width=16, height=12, n_frames=40, steps_per_call=3)}


def _train(name, fault=None):
    entry = manifest.workload_entry(MAN, name)
    config = manifest.load_config(MAN, entry["config"])
    config = dict(config, train=dict(config["train"], n_rays=32))
    mix = dict(manifest.load_traffic(entry["traffic"]), **TRAIN_MIX[name])
    cell = dict(manifest.load_cell(name), trace={"start": 1, "units": 1})
    gen = manifest.generator(mix["kind"])
    torch.set_num_threads(4)
    with faults.PATCHES[fault]() if fault else contextlib.nullcontext():
        return steps.run_cell(entry, config, mix, cell, gen, {}, seed=2**31 + 78, seconds=0.5, trace=False,
                              device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("name", sorted(TRAIN_MIX))
def test_sound_training_run_is_correct(name):
    out = _train(name)
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert out["checks"], "the cell compares no number"
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", sorted(TRAIN_MIX))
def test_broken_training_run_is_not_correct(name, fault):
    out = _train(name, fault)
    assert not out["correct"], out["checks"]
