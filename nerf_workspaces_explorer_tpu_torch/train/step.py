"""One NeRF training step.

Counterpart of `nerf_workspaces_explorer_tpu/train/step.py` (reference
NeRFReplicaTrainingHandler.step, nerf/training/nerf_replica_training_handler.py:
265-339, and `_sample_training_data`, :341-370): one random training image
and `n_rays` random pixels of it (with replacement), a training-mode
coarse+fine render, the summed coarse + fine MSE, one Adam update at the
continuously decayed learning rate lr * 0.1^(step / 50000) (:312-315).
With a proposal net in the coarse net's place (`init_train_state(
proposal_spec=)`, `RenderSettings.use_proposal`; JAX train/step.py:128-163)
the coarse term is the interlevel loss between the proposal's and the fine
net's weights, both recomposited without the sigma noise.

A step's random draws (`StepDraws`: image, pixels and the render's jitter,
noise and importance quantiles) are made by `draw_step` from a generator
that the caller seeds, or handed in by a test, so both packages can take the
same step.

Over a device mesh (`parallel/mesh.py`) `data_parallel_step` is JAX's
`make_train_step(mesh=)`: every shard takes its own pixels of one shared
image and its own render draws (`draw_shards`), renders and takes its
gradients on its device, and one Adam update applies their sum, as JAX's
step does (`DataParallelBody`, `sum_shards`).

On `cuda` the optimizer is capturable and its rate a device tensor, so that
`StepGraph` can capture K steps of either body, `apply_step` or a
`DataParallelBody`, as CUDA graphs and replay them (the counterpart of the
JAX package's `lax.scan` over steps, `make_train_step(steps_per_call=K)`,
with or without a mesh); eager steps (`take_steps`) use the same body and
optimizer, so a replay takes the steps K eager calls would.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.mlp import (
    NerfMLPSpec,
    init_nerf_params,
    tree_leaves,
    tree_unflatten,
)
from nerf_workspaces_explorer_tpu_torch.obs.profiler import span
from nerf_workspaces_explorer_tpu_torch.parallel.sharding import on_device, tree_to
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import (
    RenderDraws,
    RenderSettings,
    draw_render_randoms,
    render_ray_bundle,
)
from nerf_workspaces_explorer_tpu_torch.render.proposal import interlevel_loss
from nerf_workspaces_explorer_tpu_torch.render.volume import sigma_to_weights
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
    params: Dict[str, Any]  # {"coarse" or "proposal", "fine"}: trees of leaf tensors
    optimizer: torch.optim.Adam  # over tree_leaves(params)
    step: int  # updates taken


def make_optimizer(params: Dict[str, Any], schedule: ExponentialDecay) -> torch.optim.Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, as optax.adam) over the tree's
    leaves in `tree_leaves` order; `train_step` sets its rate per step. On
    `cuda` it is capturable (its step counts on the device) with the rate a
    device tensor, so a CUDA graph can hold the update."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    if device.type == "cuda":
        lr = torch.tensor(schedule(0), dtype=torch.float32, device=device)
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(leaves, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)


def init_train_state(
    spec: NerfMLPSpec,
    schedule: ExponentialDecay,
    device: torch.device | str = "cpu",
    *,
    seed: int = 0,
    params: Optional[Dict[str, Any]] = None,
    proposal_spec: Optional[NerfMLPSpec] = None,
) -> TrainState:
    """Fresh coarse and fine nets (drawn on the CPU from `seed`, the same on
    any device) or given `params` (a tree of arrays or tensors, e.g. a JAX
    TrainState's params through np.asarray), with zero Adam moments. With
    `proposal_spec`, a proposal net of that architecture takes the coarse
    net's place (params {"proposal", "fine"}; JAX `init_train_state`)."""
    first = "coarse" if proposal_spec is None else "proposal"
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = {first: init_nerf_params(gen, proposal_spec or spec), "fine": init_nerf_params(gen, spec)}
    tree = params_from_numpy(
        {k: params[k] for k in (first, "fine")}, device, torch.float32, requires_grad=True
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

    rays: RayBundle [N_img, H*W]; rgbs: [N_img, H*W, 3]. One gather at
    img_idx * H*W + pix_idx: indexing by a 0-d device tensor would read it
    back to the host, which a CUDA graph cannot hold."""
    flat = img_idx * rgbs.shape[1] + pix_idx
    sampled = RayBundle(*(field.reshape(-1, *field.shape[2:])[flat] for field in rays))
    return sampled, rgbs.reshape(-1, rgbs.shape[-1])[flat]


def loss_and_metrics(
    params: Dict[str, Any],
    rays: RayBundle,
    gt: torch.Tensor,
    settings: RenderSettings,
    spec: NerfMLPSpec,
    draws: RenderDraws,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Coarse + fine MSE and the reference's metrics (:111-161, the
    coarse+fine branch), sigma histograms included (:383-388). With
    `settings.use_proposal` the coarse term is the interlevel loss and
    `psnr_coarse` is 0 (JAX `_loss_and_metrics`)."""
    out = render_ray_bundle(params, rays, settings, spec=spec, draws=draws, full_outputs=True)
    rgb_loss_fine = img2mse(out["rgb_fine"], gt)
    if settings.use_proposal:
        # The histograms are recomposited without the sigma noise (JAX
        # step.py:133-141: a noisy target makes the proposal chase per-step
        # noise); the gradient reaches the proposal through its raw sigma,
        # the fine target is detached inside the loss.
        w_prop = sigma_to_weights(out["raw_coarse"][..., 3], out["z_vals_coarse"], rays.dirs)
        w_fine = sigma_to_weights(out["raw_fine"][..., 3], out["z_vals_fine"], rays.dirs)
        rgb_loss_coarse = interlevel_loss(out["z_vals_coarse"], w_prop, out["z_vals_fine"], w_fine)
        psnr_coarse = torch.zeros((), device=gt.device)  # no coarse rgb to score
    else:
        rgb_loss_coarse = img2mse(out["rgb_coarse"], gt)
        psnr_coarse = mse2psnr(rgb_loss_coarse.detach())
    total = rgb_loss_coarse + rgb_loss_fine
    metrics = {
        "rgb_loss_coarse": rgb_loss_coarse.detach(),
        "rgb_loss_fine": rgb_loss_fine.detach(),
        "total_loss": total.detach(),
        "psnr_coarse": psnr_coarse,
        "psnr_fine": mse2psnr(rgb_loss_fine.detach()),
        "trans_coarse": out["raw_coarse"][..., 3].detach(),
        "trans_fine": out["raw_fine"][..., 3].detach(),
    }
    return total, metrics


def set_learning_rate(opt: torch.optim.Adam, lr: float) -> None:
    """Every group's rate: written into the device tensor of a capturable
    optimizer, assigned otherwise."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def apply_step(
    state: TrainState,
    rays: RayBundle,
    rgbs: torch.Tensor,
    draws: StepDraws,
    settings: RenderSettings,
    spec: NerfMLPSpec,
) -> Dict[str, torch.Tensor]:
    """Sample, render, loss, backward and one Adam update at the optimizer's
    current rate, in place; the step's metrics."""
    sampled, gt = sample_training_rays(rays, rgbs, draws.img_idx, draws.pix_idx)
    loss, metrics = loss_and_metrics(
        state.params, sampled, gt, settings._replace(train=True), spec, draws.render
    )
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return metrics


def train_step(
    state: TrainState,
    rays: RayBundle,
    rgbs: torch.Tensor,
    draws: StepDraws,
    settings: RenderSettings,
    spec: NerfMLPSpec,
    schedule: ExponentialDecay,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Sample, render, loss, backward and one Adam update at lr(state.step):
    `take_step` of `apply_step`. Updates the parameters and the optimizer in
    place."""
    body = functools.partial(apply_step, state, rays, rgbs, settings=settings, spec=spec)
    return take_step(state, body, draws, schedule)


def check_mesh_rays(n_rays: int, mesh) -> int:
    """Rays per shard of a data-parallel step; `n_rays` must divide by the
    mesh size (JAX step.py:239-241)."""
    if n_rays % mesh.size != 0:
        raise ValueError(f"n_rays={n_rays} not divisible by mesh size {mesh.size}")
    return n_rays // mesh.size


def draw_shards(
    gens: Dict[torch.device, torch.Generator], seeds: List[int], img_seed: int, n_img: int, hw: int,
    n_rays: int, settings: RenderSettings, mesh,
) -> List[StepDraws]:
    """One data-parallel step's draws (JAX step.py:249-256): one image index
    for every shard, from a generator seeded `img_seed`, and per shard its
    own pixels and render draws, from `seeds[i]`, on the shard's device
    (`gens` holds a generator per distinct device)."""
    per_shard = check_mesh_rays(n_rays, mesh)
    first = mesh.devices[0]
    img_idx = torch.randint(0, n_img, (), generator=gens[first].manual_seed(img_seed), device=first)
    draws = []
    for device, seed in zip(mesh.devices, seeds):
        gen = gens[device].manual_seed(seed)
        pix_idx = torch.randint(0, hw, (per_shard,), generator=gen, device=device)
        draws.append(StepDraws(img_idx.to(device), pix_idx, draw_render_randoms(gen, per_shard, settings, device)))
    return draws


def mesh_replicas(state: TrainState, mesh) -> Dict[torch.device, Dict[str, Any]]:
    """The state's parameters on each distinct device of the mesh: the
    state's own tree on the first, a copy with leaves of its own elsewhere
    (`data_parallel_step` refreshes them after each update)."""
    first = mesh.devices[0]
    if tree_leaves(state.params)[0].device != first:
        raise ValueError(f"the state's parameters are on {tree_leaves(state.params)[0].device}, "
                         f"the mesh starts at {first}")
    out = {first: state.params}
    for device in mesh.distinct_devices[1:]:
        with torch.no_grad():
            tree = tree_to(state.params, device)
        out[device] = tree_unflatten(tree, [x.detach().requires_grad_(True) for x in tree_leaves(tree)])
    return out


# A shard's gradients (one per leaf, in `tree_leaves` order) and metrics.
ShardResult = Tuple[Tuple[torch.Tensor, ...], Dict[str, torch.Tensor]]


def shard_results(
    replicas: Dict[torch.device, Dict[str, Any]],
    rays: Dict[torch.device, RayBundle],
    rgbs: Dict[torch.device, torch.Tensor],
    draws: List[StepDraws],
    settings: RenderSettings,
    spec: NerfMLPSpec,
    mesh,
    device: torch.device,
) -> Dict[int, ShardResult]:
    """The shards of the mesh that run on `device`, by shard index: each
    one's sample, render, loss and gradients on that device, and its
    metrics.

    replicas, rays, rgbs: per distinct device, the parameter tree (leaf
    tensors), the training rays [N_img, H*W] and colours [N_img, H*W, 3].
    Gradients come from `torch.autograd.grad`, not `.backward()`: shards of
    one device share its leaves, whose `.grad` would sum them silently."""
    if len(draws) != mesh.size:
        raise ValueError(f"{len(draws)} shards' draws for a mesh of {mesh.size}")
    train_settings = settings._replace(train=True)
    out = {}
    with on_device(device):
        params = replicas[device]
        for i, (shard_device, d) in enumerate(zip(mesh.devices, draws)):
            if shard_device != device:
                continue
            sampled, gt = sample_training_rays(rays[device], rgbs[device], d.img_idx, d.pix_idx)
            loss, metrics = loss_and_metrics(params, sampled, gt, train_settings, spec, d.render)
            out[i] = (torch.autograd.grad(loss, tree_leaves(params)), metrics)
    return out


def sum_shards(results: List[ShardResult], mesh) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The gradient JAX's data-parallel step applies, formed on the mesh's
    first device in shard order (no atomics, no collective library), and
    the step's metrics, from every shard's result in shard order.

    That gradient is the SUM over shards of each shard's gradient, n times
    the gradient of the concatenated batch's mean loss. JAX's step writes
    `pmean(jax.grad(loss)(params))` inside `shard_map` (step.py:258-266),
    but there `jax.grad` of the replicated parameters already sums the
    shards' gradients (it transposes their implicit broadcast into a psum),
    so the `pmean` of that replicated sum returns it unchanged. Adam is
    scale-free up to its eps, so the sum trains as the mean would with eps
    / n; the port takes the sum to take JAX's steps.
    Scalar metrics are each shard's, averaged (a true `pmean`);
    `trans_coarse` and `trans_fine` are concatenated in shard order (JAX's
    `P(axis_name)` out-spec)."""
    first = mesh.devices[0]
    grads = list(results[0][0])
    for shard_grads, _ in results[1:]:
        grads = torch._foreach_add(grads, [g.to(first) for g in shard_grads])
    metrics = [m for _, m in results]

    def mean(xs):
        out = xs[0].to(first, copy=True)
        for x in xs[1:]:
            out += x.to(first)
        return out / mesh.size

    return grads, {k: (mean([m[k] for m in metrics]) if metrics[0][k].ndim == 0
                       else torch.cat([m[k].to(first) for m in metrics], 0)) for k in metrics[0]}


def _all_shards(shards, mesh) -> List[ShardResult]:
    """`shards(device)` on each distinct device, gathered in shard order."""
    results: Dict[int, ShardResult] = {}
    for device in mesh.distinct_devices:
        results.update(shards(device))
    return [results[i] for i in range(mesh.size)]


def data_parallel_grads(
    replicas: Dict[torch.device, Dict[str, Any]],
    rays: Dict[torch.device, RayBundle],
    rgbs: Dict[torch.device, torch.Tensor],
    draws: List[StepDraws],
    settings: RenderSettings,
    spec: NerfMLPSpec,
    mesh,
) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Each shard's gradients on its device (`shard_results`), then their
    sum on the mesh's first device and the step's metrics (`sum_shards`)."""
    return sum_shards(_all_shards(
        lambda device: shard_results(replicas, rays, rgbs, draws, settings, spec, mesh, device), mesh), mesh)


class DataParallelBody:
    """One data-parallel step (JAX step.py:232-304) at the optimizer's
    current rate, in three phases: `shards` on each device (its shards'
    gradients and metrics), `update` on the mesh's first device (the
    shards' summed gradient, as JAX applies it, and one Adam update of the
    state's parameters, which are `replicas[mesh.devices[0]]`), `refresh`
    (each other device's replica copied from them). Calling it runs the
    three in order: the step that `data_parallel_step` takes eagerly and
    `StepGraph` captures."""

    def __init__(self, state: TrainState, replicas: Dict[torch.device, Dict[str, Any]],
                 rays: Dict[torch.device, RayBundle], rgbs: Dict[torch.device, torch.Tensor],
                 settings: RenderSettings, spec: NerfMLPSpec, mesh) -> None:
        self.params, self.optimizer = state.params, state.optimizer
        self.replicas, self.rays, self.rgbs = replicas, rays, rgbs
        self.settings, self.spec, self.mesh = settings, spec, mesh

    def shards(self, device: torch.device, draws: List[StepDraws]) -> Dict[int, ShardResult]:
        return shard_results(self.replicas, self.rays, self.rgbs, draws, self.settings, self.spec, self.mesh,
                             device)

    def update(self, results: List[ShardResult]) -> Dict[str, torch.Tensor]:
        with on_device(self.mesh.devices[0]):
            grads, metrics = sum_shards(results, self.mesh)
            for p, g in zip(tree_leaves(self.params), grads):
                p.grad = g
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        return metrics

    @torch.no_grad()
    def refresh(self) -> None:
        leaves = tree_leaves(self.params)
        for device, tree in self.replicas.items():
            if device != self.mesh.devices[0]:
                for dst, src in zip(tree_leaves(tree), leaves):
                    dst.copy_(src)

    def __call__(self, draws: List[StepDraws]) -> Dict[str, torch.Tensor]:
        metrics = self.update(_all_shards(lambda device: self.shards(device, draws), self.mesh))
        self.refresh()
        return metrics


def data_parallel_step(
    state: TrainState,
    replicas: Dict[torch.device, Dict[str, Any]],
    rays: Dict[torch.device, RayBundle],
    rgbs: Dict[torch.device, torch.Tensor],
    draws: List[StepDraws],
    settings: RenderSettings,
    spec: NerfMLPSpec,
    schedule: ExponentialDecay,
    mesh,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One data-parallel step at lr(state.step), `take_step` of a
    `DataParallelBody`: the shards' gradients, their sum and one Adam update
    on the mesh's first device, each other device's replica refreshed."""
    return take_step(state, DataParallelBody(state, replicas, rays, rgbs, settings, spec, mesh), draws, schedule)


def stack_losses(steps: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The last step's metrics, with every step's total loss as
    `total_loss_steps` [K]."""
    out = dict(steps[-1])
    out["total_loss_steps"] = torch.stack([m["total_loss"] for m in steps])
    return out


def take_steps(state: TrainState, body, draws: list, schedule: ExponentialDecay
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """len(draws) consecutive steps, each at lr(step): `body(draws[i])`
    takes one step at the optimizer's current rate and returns its metrics
    (`apply_step` bound to its state and data, or a `DataParallelBody`).
    The last step's metrics and `total_loss_steps`."""
    steps = []
    for i, d in enumerate(draws):
        set_learning_rate(state.optimizer, schedule(state.step + i))
        steps.append(body(d))
    return state._replace(step=state.step + len(draws)), stack_losses(steps)


def take_step(state: TrainState, body, draws, schedule: ExponentialDecay
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step, `take_steps` of one draw: the step's metrics, without
    `total_loss_steps`."""
    state, metrics = take_steps(state, body, [draws], schedule)
    del metrics["total_loss_steps"]
    return state, metrics


def _draw_tensors(d) -> List[torch.Tensor]:
    """A step's draw tensors: one device's `StepDraws`, or a mesh's list of them."""
    if isinstance(d, StepDraws):
        return [d.img_idx, d.pix_idx, *d.render]
    return [t for shard in d for t in _draw_tensors(shard)]


def _clone_draws(d):
    if isinstance(d, StepDraws):
        return StepDraws(d.img_idx.clone(), d.pix_idx.clone(), type(d.render)(*[x.clone() for x in d.render]))
    return [_clone_draws(shard) for shard in d]


def _result_tensors(results: Dict[int, ShardResult]) -> List[torch.Tensor]:
    return [t for i in sorted(results) for t in (*results[i][0], *results[i][1].values())]


def _pack(results: Dict[int, ShardResult]) -> torch.Tensor:
    """Shards' results as one flat fp32 buffer (gradients, then metrics, shard by shard)."""
    return torch.cat([t.reshape(-1) for t in _result_tensors(results)])


def _unpack(flat: torch.Tensor, like: Dict[int, ShardResult]) -> Dict[int, ShardResult]:
    """Views of `_pack`'s buffer in the layout of `like`."""
    like_tensors = _result_tensors(like)
    views = iter([x.view(t.shape) for x, t in zip(flat.split([t.numel() for t in like_tensors]), like_tensors)])
    return {i: (tuple(next(views) for _ in like[i][0]), {k: next(views) for k in like[i][1]}) for i in sorted(like)}


class StepGraph:
    """K consecutive training steps as CUDA graphs, captured at the first
    call and replayed at every later one.

    A step is a body (`take_steps`): `apply_step` bound to one device's
    state and data (sampling, render, loss, backward through K4/K5 on the
    fused field, capturable Adam update), or a `DataParallelBody` over a
    mesh. The graphs' inputs are static buffers: each step's draws and
    learning rate, copied in before a replay from draws the caller made
    outside the graph and from `schedule(step)`, so a replay takes the same
    steps as `take_steps` with the same body. The first call takes its K
    steps eagerly on a side stream of each device (PyTorch's whole-network
    capture recipe: the kernels build, the optimizer state and the packing
    indices exist before the capture), then captures without running
    anything. A failed capture or replay raises; nothing falls back to
    eager steps.

    Where every step's work sits on one card (one device, or a mesh whose
    shards repeat one card), one graph holds all K steps. A mesh over
    distinct cards gets, for each step, a graph on each card for its
    shards (gradients and metrics packed into one flat buffer) and a graph
    on the first card for the sum and the Adam update, replayed in that
    order: K * (cards + 1) replays a call. Between them, each card's flat
    buffer is copied to the first card and each replica refreshed
    (`DataParallelBody.refresh`) by eager copies, which PyTorch orders
    against both cards' current streams with events. One capture across
    cards would need the other cards' streams to join the first card's
    capture, while PyTorch's cross-device copies synchronize the cards'
    current streams and its graph memory pool serves one device; a graph a
    card keeps each capture on one device. `per_card=True` takes that path
    on one card as well.

    A call is the span `train.capture` (the first) or `train.replay`
    (the input copies and the replays)."""

    def __init__(self, k: int, *, per_card: Optional[bool] = None) -> None:
        self.k = k
        self.per_card = per_card
        self.graph: Optional[torch.cuda.CUDAGraph] = None  # all K steps, on one card
        self._plan: Optional[list] = None  # per step: (card graphs, copies, update graph), across cards

    @property
    def captured(self) -> bool:
        return self.graph is not None or self._plan is not None

    def __call__(self, state: TrainState, body, draws: list, schedule: ExponentialDecay
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if len(draws) != self.k:
            raise ValueError(f"the graph takes {self.k} steps, got draws for {len(draws)}")
        if not all(isinstance(g["lr"], torch.Tensor) for g in state.optimizer.param_groups):
            raise ValueError("a graphed step needs the capturable optimizer of make_optimizer on cuda")
        if not self.captured:
            with span("train.capture"):
                return self._warm_and_capture(state, body, draws, schedule)
        with span("train.replay"):
            return self._replay(state, draws, schedule)

    def _replay(self, state, draws, schedule):
        for static, d in zip(self._draws, draws):
            for dst, src in zip(_draw_tensors(static), _draw_tensors(d)):
                dst.copy_(src)
        lrs = torch.tensor([schedule(state.step + i) for i in range(self.k)], dtype=torch.float32,
                           pin_memory=True)
        self._lr.copy_(lrs, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
            metrics = self._metrics
        else:
            for card_graphs, copies, update in self._plan:
                for graph in card_graphs:
                    graph.replay()
                for dst, src in copies:
                    dst.copy_(src)
                update.replay()
                self._body.refresh()
            metrics = stack_losses(self._step_metrics)
        return state._replace(step=state.step + self.k), {k: v.clone() for k, v in metrics.items()}

    def _warm_and_capture(self, state, body, draws, schedule):
        devices = list(dict.fromkeys(t.device for t in _draw_tensors(draws[0])))
        sides = [torch.cuda.Stream(device) for device in devices]
        with contextlib.ExitStack() as stack:
            for side in sides:
                side.wait_stream(torch.cuda.current_stream(side.device))
                stack.enter_context(torch.cuda.stream(side))
            state_after, metrics = take_steps(state, body, draws, schedule)
            metrics = {k: v.clone() for k, v in metrics.items()}
        for side in sides:
            torch.cuda.current_stream(side.device).wait_stream(side)

        self._draws = [_clone_draws(d) for d in draws]
        self._lr = torch.empty(self.k, dtype=torch.float32, device=devices[0])
        per_card = len(devices) > 1 if self.per_card is None else self.per_card
        if per_card:
            if not isinstance(body, DataParallelBody):
                raise ValueError("graphs a card need a DataParallelBody")
            self._capture_per_card(state.optimizer, body, devices)
        else:
            self._capture_whole(state.optimizer, body, devices[0])
        return state_after, metrics

    def _set_rate(self, opt: torch.optim.Adam, i: int) -> None:
        for group in opt.param_groups:
            group["lr"].copy_(self._lr[i])

    def _capture_whole(self, opt, body, device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
            steps = []
            for i in range(self.k):
                self._set_rate(opt, i)
                steps.append(body(self._draws[i]))
            self._metrics = stack_losses(steps)
        self.graph = graph

    def _capture_per_card(self, opt, body, devices):
        first = devices[0]
        pools: Dict[torch.device, Any] = {}
        plan, self._step_metrics, self._static = [], [], []
        for i in range(self.k):
            card_graphs, staged, copies = [], [], []
            for device in devices:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.device(device), torch.cuda.graph(graph, pool=pools.get(device),
                                                                 stream=torch.cuda.Stream(device)):
                    results = body.shards(device, self._draws[i])
                    flat = _pack(results)
                pools.setdefault(device, graph.pool())
                card_graphs.append(graph)
                if device != first:
                    copies.append((torch.empty_like(flat, device=first), flat))
                    staged.append((copies[-1][0], results))
                else:
                    staged.append((flat, results))
            update = torch.cuda.CUDAGraph()
            with torch.cuda.device(first), torch.cuda.graph(update, pool=pools[first],
                                                            stream=torch.cuda.Stream(first)):
                self._set_rate(opt, i)
                results = {}
                for flat, like in staged:
                    results.update(_unpack(flat, like))
                self._step_metrics.append(body.update([results[j] for j in range(body.mesh.size)]))
            self._static.append((staged, copies))  # every static buffer lives as long as the graphs
            plan.append((card_graphs, copies, update))
        self._plan, self._body = plan, body


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
        capturable = opt.param_groups[0].get("capturable", False)
        opt.state[p] = {
            "step": torch.tensor(float(count), device=p.device if capturable else "cpu"),
            "exp_avg": mu.clone(),
            "exp_avg_sq": nu.clone(),
        }
    return state._replace(step=count)
