"""Faults planted in the program under a whole run, to see `correct` come
out false (`tests/test_benchmark_faults.py` on the CPU) and to read what
each fault does to a cell's numbers (`harness/control.py --fault` on the
card). Each is a context manager that patches the program and restores it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def half_rays():
    """The fused path leaves half of a frame's rays black where it
    composites them."""
    import nerf_workspaces_explorer_tpu_torch.ops.fused_render as fr

    real = fr._finish

    def finish(maps, settings, full):
        out = real(maps, settings, full).clone()
        out[out.shape[0] // 2 :] = 0.0
        return out

    fr._finish = finish
    try:
        yield
    finally:
        fr._finish = real


def stale_answer(serve):
    """A serve that answers each request with the frame of the one before."""
    last = {}

    def stale(system, req):
        frame = serve(system, req)
        prev, last["f"] = last.get("f", frame), frame
        return prev

    return stale


@contextlib.contextmanager
def state_unchanged():
    """Each training step computes its update and then puts the parameters
    back as they were."""
    import nerf_workspaces_explorer_tpu_torch.train.loop as loop

    real = loop.apply_step

    def apply_step(state, *args, **kwargs):
        params = state.optimizer.param_groups[0]["params"]
        before = [p.detach().clone() for p in params]
        metrics = real(state, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return metrics

    loop.apply_step = apply_step
    try:
        yield
    finally:
        loop.apply_step = real


@contextlib.contextmanager
def half_batch():
    """The training loss takes its mean over the first half of the batch."""
    import nerf_workspaces_explorer_tpu_torch.train.step as step_mod

    real = step_mod.img2mse
    step_mod.img2mse = lambda p, t: torch.mean((p[: len(p) // 2] - t[: len(t) // 2]) ** 2)
    try:
        yield
    finally:
        step_mod.img2mse = real


PATCHES = {"half_rays": half_rays, "state_unchanged": state_unchanged, "half_batch": half_batch}
