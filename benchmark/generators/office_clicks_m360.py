"""Clicks on the explorer's floor plans served by `Workspace.render_image`
with mip-NeRF 360 (`NeRFRenderer(preset="mipnerf360")`).

The requests, the warm-up and the reference poses are `office_clicks`'
(loaded from its file): the same pool of clicks and order for a seed. Only
the system differs: each office's renderer serves the configuration's
seeded checkpoint, and the frames are judged by `harness/frames_m360.py`.

Mix parameters: `office_clicks`'.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("bench_generator_office_clicks_base",
                                               os.path.join(_BENCH, "generators", "office_clicks.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)

# The harness module that times and judges these requests.
DRIVER = "frames_m360"

requests = _base.requests
warmup = _base.warmup
serve = _base.serve
reference_pose = _base.reference_pose


def build(config: dict, mix: dict, device, precision: str):
    """One workspace an office, each with its own renderer on the seeded
    checkpoint at the configuration's preset and precision, at the mix's
    frame size."""
    from nerf_workspaces_explorer_tpu_torch.app.workspace import WORKSPACE_CLASSES
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    ckpt = os.path.join(os.path.dirname(_BENCH), config["serve"]["checkpoint"])
    spaces = {}
    for office in mix["offices"]:
        cfg = load_config(office_name=office)
        cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(
            cfg.experiment, image_width=int(mix["width"]), image_height=int(mix["height"])))
        renderer = NeRFRenderer(office, ckpt, config=cfg, precision=precision, preset=config["serve"]["preset"],
                                device=device)
        space = WORKSPACE_CLASSES[office](renderer=renderer)
        space.initialize_models()
        spaces[office] = space
    return spaces
