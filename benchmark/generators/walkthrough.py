"""A walk through the synthetic room, served by `NeRFRenderer.render_pose_uint8`.

A closed loop of one client with no think time: each request is the next
pose of the room's figure-eight walkthrough of `n_frames` poses (a frozen
copy, `reference/poses.py`), answered with the uint8 frame on the host.
The run's seed draws the start; the walk wraps round, so a window longer
than one loop does nearly the same work from any start.

Mix parameters: width, height, n_frames, half (the room's half extents).
"""

from __future__ import annotations

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
    n = int(mix["n_frames"])
    poses = ref_poses.walkthrough_poses(n, tuple(mix["half"]))
    start = int(np.random.default_rng(np.random.SeedSequence([int(seed), 2])).integers(0, n))
    return [dict(index=(start + k) % n, pose=poses[(start + k) % n]) for k in range(n)]


def warmup(reqs: list, mix: dict) -> list:
    """Two poses: the first frame and one at the frame's steady state."""
    return reqs[:2]


def build(config: dict, mix: dict, device, precision: str):
    """The renderer on the configuration's checkpoint, preset and precision,
    with the checkpoint's depth range, at the mix's frame size."""
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    serve = config["serve"]
    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(
        cfg,
        experiment=dataclasses.replace(cfg.experiment, image_width=int(mix["width"]), image_height=int(mix["height"])),
        rendering=dataclasses.replace(cfg.rendering, depth_range=tuple(float(v) for v in serve["depth_range"])),
    )
    ckpt = os.path.join(os.path.dirname(_BENCH), serve["checkpoint"])
    renderer = NeRFRenderer("tokyo", ckpt, config=cfg, precision=precision, preset=serve["preset"],
                            early_stop_eps=float(serve["early_stop_eps"]), device=device)
    renderer.initialize_models()
    return renderer


def serve(system, req: dict) -> np.ndarray:
    return system.render_pose_uint8(req["pose"]).cpu().numpy()


def reference_pose(req: dict, mix: dict) -> np.ndarray:
    return req["pose"]

