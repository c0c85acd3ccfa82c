"""One NeRF training step.

Counterpart of `nerf_workspaces_explorer_tpu/train/step.py` (reference
NeRFReplicaTrainingHandler.step, nerf/training/nerf_replica_training_handler.py:
265-339, and `_sample_training_data`, :341-370): one random training image
and `n_rays` random pixels of it (with replacement), a training-mode
coarse+fine render, the summed coarse + fine MSE, one Adam update at the
continuously decayed learning rate lr * 0.1^(step / 50000) (:312-315).

A step's random draws (`StepDraws`: image, pixels and the render's jitter,
noise and importance quantiles) are made by `draw_step` from a generator
that the caller seeds, or handed in by a test, so both packages can take the
same step.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import (
    NerfMLPSpec,
    init_nerf_params,
    tree_leaves,
)
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import (
    RenderDraws,
    RenderSettings,
    draw_render_randoms,
    render_ray_bundle,
)
from nerf_workspaces_explorer_tpu_torch.utils.metrics import img2mse, mse2psnr


class ExponentialDecay(NamedTuple):
    """lr(step) = learning_rate * decay_rate^(step / decay_steps), continuous
    (optax `exponential_decay(staircase=False)`; reference :312-315)."""

    learning_rate: float = 5e-4
    decay_rate: float = 0.1
    decay_steps: float = 50_000.0

    def __call__(self, step: int) -> float:
        return self.learning_rate * self.decay_rate ** (step / self.decay_steps)


class TrainState(NamedTuple):
    params: Dict[str, Any]  # {"coarse", "fine"}: trees of leaf tensors
    optimizer: torch.optim.Adam  # over tree_leaves(params)
    step: int  # updates taken


def make_optimizer(params: Dict[str, Any], schedule: ExponentialDecay) -> torch.optim.Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, as optax.adam) over the tree's
    leaves in `tree_leaves` order; `train_step` sets its rate per step."""
    return torch.optim.Adam(
        tree_leaves(params), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8
    )


def init_train_state(
    spec: NerfMLPSpec,
    schedule: ExponentialDecay,
    device: torch.device | str = "cpu",
    *,
    seed: int = 0,
    params: Optional[Dict[str, Any]] = None,
) -> TrainState:
    """Fresh coarse and fine nets (drawn on the CPU from `seed`, the same on
    any device) or given `params` (a tree of arrays or tensors, e.g. a JAX
    TrainState's params through np.asarray), with zero Adam moments."""
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = {"coarse": init_nerf_params(gen, spec), "fine": init_nerf_params(gen, spec)}
    tree = params_from_numpy(
        {k: params[k] for k in ("coarse", "fine")}, device, torch.float32, requires_grad=True
    )
    return TrainState(params=tree, optimizer=make_optimizer(tree, schedule), step=0)


class StepDraws(NamedTuple):
    """A step's random draws: image index (int64 scalar tensor), pixel
    indices [n_rays] and the render's draws."""

    img_idx: torch.Tensor
    pix_idx: torch.Tensor
    render: RenderDraws


def draw_step(
    gen: torch.Generator, n_img: int, hw: int, n_rays: int, settings: RenderSettings,
    device: torch.device,
) -> StepDraws:
    """The draws of one step from `gen` (a generator on `device`)."""
    img_idx = torch.randint(0, n_img, (), generator=gen, device=device)
    pix_idx = torch.randint(0, hw, (n_rays,), generator=gen, device=device)
    return StepDraws(img_idx, pix_idx, draw_render_randoms(gen, n_rays, settings, device))


def sample_training_rays(
    rays: RayBundle, rgbs: torch.Tensor, img_idx: torch.Tensor, pix_idx: torch.Tensor
) -> Tuple[RayBundle, torch.Tensor]:
    """One image's pixels (reference _sample_training_data, :341-370).

    rays: RayBundle [N_img, H*W]; rgbs: [N_img, H*W, 3]."""
    sampled = RayBundle(*(field[img_idx][pix_idx] for field in rays))
    return sampled, rgbs[img_idx][pix_idx]


def loss_and_metrics(
    params: Dict[str, Any],
    rays: RayBundle,
    gt: torch.Tensor,
    settings: RenderSettings,
    spec: NerfMLPSpec,
    draws: RenderDraws,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Coarse + fine MSE and the reference's metrics (:111-161, the
    coarse+fine branch), sigma histograms included (:383-388)."""
    out = render_ray_bundle(params, rays, settings, spec=spec, draws=draws, full_outputs=True)
    rgb_loss_fine = img2mse(out["rgb_fine"], gt)
    rgb_loss_coarse = img2mse(out["rgb_coarse"], gt)
    total = rgb_loss_coarse + rgb_loss_fine
    metrics = {
        "rgb_loss_coarse": rgb_loss_coarse.detach(),
        "rgb_loss_fine": rgb_loss_fine.detach(),
        "total_loss": total.detach(),
        "psnr_coarse": mse2psnr(rgb_loss_coarse.detach()),
        "psnr_fine": mse2psnr(rgb_loss_fine.detach()),
        "trans_coarse": out["raw_coarse"][..., 3].detach(),
        "trans_fine": out["raw_fine"][..., 3].detach(),
    }
    return total, metrics


def train_step(
    state: TrainState,
    rays: RayBundle,
    rgbs: torch.Tensor,
    draws: StepDraws,
    settings: RenderSettings,
    spec: NerfMLPSpec,
    schedule: ExponentialDecay,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Sample, render, loss, backward and one Adam update at lr(state.step).
    Updates the parameters and the optimizer in place."""
    sampled, gt = sample_training_rays(rays, rgbs, draws.img_idx, draws.pix_idx)
    loss, metrics = loss_and_metrics(
        state.params, sampled, gt, settings._replace(train=True), spec, draws.render
    )
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for group in opt.param_groups:
        group["lr"] = schedule(state.step)
    opt.step()
    return state._replace(step=state.step + 1), metrics


def optimizer_leaves(state: TrainState) -> List[np.ndarray]:
    """The Adam state as optax.adam's flattened leaves (count, mu leaves, nu
    leaves, the schedule's count), so checkpoints carry it in the JAX
    package's `opt||i` layout. Moments are zero before the first update."""
    leaves = tree_leaves(state.params)
    mu, nu = [], []
    for p in leaves:
        st = state.optimizer.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        mu.append(st["exp_avg"].detach().cpu().numpy() if st else zeros)
        nu.append(st["exp_avg_sq"].detach().cpu().numpy() if st else zeros)
    count = np.asarray(state.step, np.int32)
    return [count, *mu, *nu, count]


def load_optimizer_leaves(state: TrainState, opt_leaves: List[np.ndarray]) -> TrainState:
    """Restore `optimizer_leaves`' layout into the state's Adam (and step)."""
    leaves = tree_leaves(state.params)
    n = len(leaves)
    if len(opt_leaves) != 2 * n + 2:
        raise ValueError(f"optimizer state has {len(opt_leaves)} leaves, expected {2 * n + 2}")
    count = int(np.asarray(opt_leaves[0]))
    opt = state.optimizer
    for i, p in enumerate(leaves):
        mu, nu = (torch.as_tensor(np.asarray(x, np.float32), device=p.device)
                  for x in (opt_leaves[1 + i], opt_leaves[1 + n + i]))
        if mu.shape != p.shape or nu.shape != p.shape:
            raise ValueError(f"optimizer leaf {i} has shape {tuple(mu.shape)}, param {tuple(p.shape)}")
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu.clone(),
            "exp_avg_sq": nu.clone(),
        }
    return state._replace(step=count)
