"""Training steps on views of the synthetic room, through `Trainer.step_many`.

The work is a run of training steps on the configuration's nets, calls of
`Trainer.step_many` of K steps each (`steps_per_call`; on the card a
replay of the CUDA graph its first call captured). Its data is made here
from the seed, on the device: the views are every `every`-th pose of the room's
figure-eight walkthrough (a frozen copy, `reference/poses.py`), and their
colours smooth random fields (a few sinusoids a channel and view). A step's
work does not depend on the colours, only its loss does.

Mix parameters: width, height, n_frames, every, half, steps_per_call,
waves (sinusoids a channel).
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np
import torch

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _BENCH not in sys.path:
    sys.path.insert(0, _BENCH)

from reference import nerf  # noqa: E402
from reference import poses as ref_poses  # noqa: E402
from reference import train as ref_train  # noqa: E402

# The harness module that times and judges these steps.
DRIVER = "steps"


def views(mix: dict) -> np.ndarray:
    """float32 [N, 4, 4]: the training views' poses."""
    return ref_poses.walkthrough_poses(int(mix["n_frames"]), tuple(mix["half"]))[:: int(mix["every"])]


def colours(mix: dict, n: int, seed: int, device) -> torch.Tensor:
    """float32 [n, H, W, 3] in [0, 1]: per view and channel, 0.5 plus a sum
    of `waves` random plane waves over the pixel grid, drawn in one call of a
    generator on `device` seeded from the seed."""
    h, w, k = int(mix["height"]), int(mix["width"]), int(mix["waves"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), 6]).generate_state(1)[0]))
    p = torch.rand((n, 3, k, 4), generator=gen, device=device)
    ys = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xs = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    out = torch.full((n, 3, h, w), 0.5, device=device)
    for j in range(k):
        fx, fy, ph, amp = (p[:, :, j, c, None, None] for c in range(4))
        out += (0.35 / k) * (0.5 + amp) * torch.sin(2 * math.pi * (4 * fx * xs + 4 * fy * ys + ph))
    return out.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def build(config: dict, mix: dict, device, seed: int):
    """The Trainer on the configuration, as the train CLI makes it, with the
    benchmark's data and initial weights (`reference/train.py::init_weights`)
    copied into its parameters before any step."""
    import dataclasses

    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.replica import SceneData
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    train = config["train"]
    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(
        cfg,
        experiment=dataclasses.replace(cfg.experiment, image_width=int(mix["width"]), image_height=int(mix["height"])),
        rendering=dataclasses.replace(cfg.rendering, n_rays=int(train["n_rays"]), n_samples=int(train["n_samples"]),
                                      n_importance=int(train["n_importance"]),
                                      depth_range=tuple(float(v) for v in train["depth_range"])),
        training=dataclasses.replace(cfg.training, learning_rate=float(train["learning_rate"])),
    )
    poses = views(mix)
    rgb = colours(mix, len(poses), seed, device)
    rgb_host = rgb.cpu().numpy()
    depth = np.zeros(rgb_host.shape[:3], np.float32)
    data = SceneData(rgb_host, depth, poses)
    test = SceneData(rgb_host[:1], depth[:1], poses[:1])
    save_dir = tempfile.mkdtemp(prefix="bench-trainer-")
    trainer = Trainer("tokyo", cfg, train_data=data, test_data=test, save_dir=save_dir, enable_tensorboard=False,
                      seed=int(seed), field_impl=train["field_impl"], steps_per_call=int(mix["steps_per_call"]),
                      device=device)
    trainer.setup()
    init = ref_train.init_weights(config["nets"], seed, device)
    _copy_into(trainer.params, init)
    return dict(trainer=trainer, init=init, poses=poses, rgb=rgb, save_dir=save_dir)


def _copy_into(params: dict, tree: dict) -> None:
    with torch.no_grad():
        for net, layers in params.items():
            for key, layer in layers.items():
                items = layer if isinstance(layer, list) else [layer]
                for i, leaf in enumerate(items):
                    name = f"{net}/{key}/{i}" if isinstance(layer, list) else f"{net}/{key}"
                    leaf["w"].copy_(tree[f"{name}/w"])
                    leaf["b"].copy_(tree[f"{name}/b"])


def leaves(params: dict) -> dict:
    """The program's parameter tree as the reference's flat names."""
    out = {}
    for net, layers in params.items():
        for key, layer in layers.items():
            items = layer if isinstance(layer, list) else [layer]
            for i, leaf in enumerate(items):
                name = f"{net}/{key}/{i}" if isinstance(layer, list) else f"{net}/{key}"
                out[f"{name}/w"], out[f"{name}/b"] = leaf["w"], leaf["b"]
    return out


def optimizer(system):
    return system["trainer"].state.optimizer


def call(system, step: int) -> torch.Tensor:
    """Steps step .. step + K - 1 in one call of `Trainer.step_many`; each
    step's total loss, on the device."""
    return system["trainer"].step_many(step)["total_loss_steps"]


def steps_per_call(mix: dict) -> int:
    return int(mix["steps_per_call"])


def free(system) -> None:
    import shutil

    shutil.rmtree(system["save_dir"], ignore_errors=True)


def reference_inputs(system, mix: dict, device) -> tuple:
    """The rays {"origins", "dirs", "viewdirs"} [N, H W, 3] of the training
    views, worked out by the reference, and the colours [N, H W, 3]."""
    h, w = int(mix["height"]), int(mix["width"])
    per = [nerf.rays(p, h, w, device=device) for p in system["poses"]]
    rays = {k: torch.stack([r[i] for r in per]) for i, k in enumerate(("origins", "dirs", "viewdirs"))}
    return rays, system["rgb"].reshape(len(per), h * w, 3)
