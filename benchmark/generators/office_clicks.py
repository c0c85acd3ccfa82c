"""Clicks on the explorer's floor plans, served by `Workspace.render_image`.

A closed loop of one client with no think time: each request is a click
(office, rel_x, rel_y, horizontal angle, vertical angle) answered with the
uint8 frame on the host. The pool of clicks is fixed by the mix's
`pool_seed`: `per_office` clicks on each office, rel_x and rel_y uniform in
the office's `rel` box, the horizontal angle a multiple of `hor_step`
degrees, the vertical angle one of `ver_angles`. The run's seed orders
each office's clicks, and the offices take turns. So every seed serves the
same frames in another order, and a window of whole rounds does the same
work whatever the seed.

Mix parameters: width, height, offices, rel {office: [[x lo, x hi], [y lo,
y hi]]}, hor_step, ver_angles, per_office, pool_seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _BENCH not in sys.path:
    sys.path.insert(0, _BENCH)

from reference import poses as ref_poses  # noqa: E402

# The harness module that times and judges these requests.
DRIVER = "frames"


def requests(mix: dict, seed: int) -> list:
    pool = np.random.default_rng(int(mix["pool_seed"]))
    per_office = {}
    for office in mix["offices"]:
        (x0, x1), (y0, y1) = mix["rel"][office]
        n = int(mix["per_office"])
        per_office[office] = [
            dict(office=office, rel_x=float(pool.uniform(x0, x1)), rel_y=float(pool.uniform(y0, y1)),
                 hor=int(mix["hor_step"]) * int(pool.integers(0, 360 // int(mix["hor_step"]))),
                 ver=int(pool.choice(mix["ver_angles"])))
            for _ in range(n)
        ]
    order = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    for office in mix["offices"]:
        per_office[office] = [per_office[office][i] for i in order.permutation(len(per_office[office]))]
    return [per_office[o][k] for k in range(int(mix["per_office"])) for o in mix["offices"]]


def warmup(reqs: list, mix: dict) -> list:
    """One click on each office: each office's renderer serves its first frame."""
    return reqs[: len(mix["offices"])]


def build(config: dict, mix: dict, device, precision: str):
    """One workspace an office, as the explorer makes them, each with its own
    renderer on the configuration's checkpoint, preset and precision, at the
    mix's frame size."""
    from nerf_workspaces_explorer_tpu_torch.app.workspace import WORKSPACE_CLASSES
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    serve = config["serve"]
    ckpt = os.path.join(os.path.dirname(_BENCH), serve["checkpoint"])
    spaces = {}
    for office in mix["offices"]:
        cfg = load_config(office_name=office)
        cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(
            cfg.experiment, image_width=int(mix["width"]), image_height=int(mix["height"])))
        renderer = NeRFRenderer(office, ckpt, config=cfg, precision=precision, preset=serve["preset"],
                                early_stop_eps=float(serve["early_stop_eps"]), device=device)
        space = WORKSPACE_CLASSES[office](renderer=renderer)
        space.initialize_models()
        spaces[office] = space
    return spaces


def serve(system, req: dict) -> np.ndarray:
    # render_image prints the reference application's console trace of the
    # pose on every click; it is formatted and written, to the null device.
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return system[req["office"]].render_image(req["rel_x"], req["rel_y"], req["hor"], req["ver"])


def reference_pose(req: dict, mix: dict) -> np.ndarray:
    return ref_poses.click_pose(req["office"], req["rel_x"], req["rel_y"], req["hor"], req["ver"])

