"""A multi-device dry run of the port: one data-parallel training step and
the sharded renders, each held against its single-device counterpart.

Counterpart of `__graft_entry__.py::dryrun_multichip` (:103-300), in its
order and with its gate (every sharded-against-single comparison under
5e-3), at the flagship width by default (8x256, 64 + 128 samples):
  - one data-parallel step, whose gradient (the shards' sum, as JAX's step
    applies it) over the shard count is first held against the
    single-device gradient of the same rays (the shards' batches
    concatenated, the same draws) to the fused field's bound;
  - a sharded plain render of a frame, and the fused leg per shard against
    it;
  - the serving configuration, the 2x64 proposal net and the int8 kernels
    (`ops/quantize.py`), sharded against single;
  - a turbo student (6x192@10f, importance-only placement, 48 samples)
    sharded against single, and on the stride-4 placement lattice;
  - with `graph_steps` K, calls of K data-parallel steps as a `StepGraph`
    (`Trainer(mesh=, steps_per_call=K)`'s path; on the CPU K eager steps of
    the same body) against the same steps taken eagerly, losses equal to
    1e-6.
On the card each leg's kernel launches are counted, so a caller can check
that every shard went through the kernels (a graph's replays launch
through no wrapper: its launches are those of its first call, the warm-up
steps and the capture).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.encoding import embedding_output_dim
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, init_nerf_params, tree_leaves, tree_unflatten
from nerf_workspaces_explorer_tpu_torch.ops import fused_field, fused_render, importance_merge
from nerf_workspaces_explorer_tpu_torch.ops.quantize import calibrate_model_quant
from nerf_workspaces_explorer_tpu_torch.parallel.mesh import data_mesh
from nerf_workspaces_explorer_tpu_torch.parallel.sharding import replicas, shard_render, tree_to
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderDraws, RenderSettings
from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec
from nerf_workspaces_explorer_tpu_torch.train.step import (
    DataParallelBody,
    ExponentialDecay,
    StepDraws,
    StepGraph,
    apply_step,
    data_parallel_grads,
    data_parallel_step,
    draw_shards,
    draw_step,
    init_train_state,
    loss_and_metrics,
    mesh_replicas,
    sample_training_rays,
    take_steps,
    train_step,
)

TOLERANCE = 5e-3  # sharded against single (__graft_entry__.py:223, :266, :294)
FIELD_GRAD_REL = 0.08  # the fused field's gradients (tests/test_pallas_train.py:54-56)
GRAPH_LOSS_ATOL = 1e-6  # replayed against eager steps: the same arithmetic
GRAPH_CALLS = 3  # the first captures, the rest replay
STRIDE = 4  # the turbo preset's placement lattice
TURBO_STUDENT = NerfMLPSpec(depth=6, width=192, input_ch=embedding_output_dim(10),
                            input_ch_views=embedding_output_dim(4))
TURBO_SAMPLES = 48


def _launches() -> Dict[str, int]:
    """Every kernel counter: K1/K3/K7 by pass and mode, K2/K6, and K4/K5
    calls by library."""
    out = {f"render_{k}": v for k, v in fused_render.LAUNCHES.items()}
    out.update({f"placement_{k}": v for k, v in importance_merge.LAUNCHES.items()})
    for lib, counts in fused_field.SHAPE_LAUNCHES.items():
        out.update({f"{lib}_{k}": v for k, v in counts.items()})
    return out


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _uint8(x: torch.Tensor) -> np.ndarray:
    return torch.floor(255.0 * torch.clamp(x.float(), 0.0, 1.0)).to(torch.uint8).cpu().numpy()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multigpu(
    n_devices: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
    spec: Optional[NerfMLPSpec] = None,
    settings: Optional[RenderSettings] = None,
    student_spec: NerfMLPSpec = TURBO_STUDENT,
    height: int = 240,
    width: int = 320,
    n_rays: int = 1024,
    seed: int = 0,
    time_reps: int = 0,
    graph_steps: int = 0,
) -> Dict[str, Any]:
    """Run the dry run over `data_mesh(n_devices, devices=devices)` and
    print its one line; raise on a failed check. The frame is `height` x
    `width` rays, whose rows must split over the mesh into blocks the
    stride-4 lattice divides; the step takes `n_rays` rays, which must split
    over the mesh. With `graph_steps` K > 0 it also takes GRAPH_CALLS calls
    of K data-parallel steps through a `StepGraph` (on `cuda`) against the
    same steps eagerly. With `time_reps` > 0 the report also holds warm ms
    (host clock, synchronized) of the sharded fused frame and of a
    data-parallel step against their single-device counterparts, the median
    of that many, and with K > 0 those of a K-step graph call over K, over
    the mesh and on the first device alone.

    Returns a report: the loss, each comparison's max |err|, whether the
    uint8 frames are byte-equal, and each leg's kernel launches."""
    mesh = data_mesh(n_devices, devices=devices)
    n, first = mesh.size, mesh.devices[0]
    spec = spec or NerfMLPSpec()
    settings = settings or RenderSettings()
    if height % n or (height // n) % STRIDE or width % STRIDE:
        raise ValueError(f"a {width}x{height} frame does not split over {n} shards into stride-{STRIDE} row blocks")
    field_impl = "fused" if first.type == "cuda" else "plain"
    report: Dict[str, Any] = {"n_devices": n, "launches": {}}

    # 1. One data-parallel training step (JAX :125-143), its gradient first
    # held against the single-device gradient of the concatenated batch.
    train_settings = settings._replace(train=True, raw_noise_std=1.0, field_impl=field_impl)
    schedule = ExponentialDecay()
    state = init_train_state(spec, schedule, first, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    n_img, size = 2, 16
    poses = torch.eye(4).repeat(n_img, 1, 1)
    poses[1, :3, 3] = torch.tensor([0.2, -0.1, 0.3])
    rays_train = create_rays(poses.to(first), size, size, 8.0, 8.0, 7.5, 7.5, 0.1, 6.0)
    rgbs = torch.rand((n_img, size * size, 3), generator=gen).to(first)
    shard_params = mesh_replicas(state, mesh)
    rays_d = {d: tree_to(rays_train, d) for d in mesh.distinct_devices}
    rgbs_d = {d: rgbs.to(d) for d in mesh.distinct_devices}
    gens = {d: torch.Generator(device=d) for d in mesh.distinct_devices}
    seeds = [int(s) for s in np.random.SeedSequence([seed, 2]).generate_state(n)]
    draws = draw_shards(gens, seeds, seed + 3, n_img, size * size, n_rays, train_settings, mesh)
    grads, metrics = data_parallel_grads(shard_params, rays_d, rgbs_d, draws, train_settings, spec, mesh)
    joined = StepDraws(draws[0].img_idx.to(first), torch.cat([d.pix_idx.to(first) for d in draws]),
                       RenderDraws(*(torch.cat([getattr(d.render, f).to(first) for d in draws])
                                     for f in RenderDraws._fields)))
    sampled, gt = sample_training_rays(rays_train, rgbs, joined.img_idx, joined.pix_idx)
    loss_single, _ = loss_and_metrics(state.params, sampled, gt, train_settings, spec, joined.render)
    grads_single = torch.autograd.grad(loss_single, tree_leaves(state.params))
    grad_rel = max(_max_err(a / n, b) / (float(b.abs().max()) + 1e-12) for a, b in zip(grads, grads_single))
    report["loss_single"] = float(loss_single.detach())
    report["grad_rel"] = grad_rel
    _check(grad_rel < FIELD_GRAD_REL, f"data-parallel gradient diverges from the single-device one: rel {grad_rel}")
    before = _launches()
    state, metrics = data_parallel_step(state, shard_params, rays_d, rgbs_d, draws, train_settings, spec,
                                        schedule, mesh)
    _sync(first)
    report["launches"]["train_step"] = _delta(before)
    loss = float(metrics["total_loss"])
    report["loss"] = loss
    _check(state.step == 1, f"step count {state.step} after one step")
    _check(bool(np.isfinite(loss)), f"non-finite loss {loss} in the multi-device dry run")
    _check(tuple(metrics["trans_fine"].shape[:1]) == (n_rays,), f"trans_fine {tuple(metrics['trans_fine'].shape)}")

    # 2. A sharded plain render of one frame, then the fused leg per shard
    # against it (JAX :145-167).
    params = tree_unflatten(state.params, [x.detach() for x in tree_leaves(state.params)])
    eval_settings = settings._replace(field_impl="plain")
    pose = torch.eye(4, device=first)
    frame = create_rays(pose[None], height, width, width / 2.0, width / 2.0, (width - 1) / 2.0, (height - 1) / 2.0,
                        0.1, 6.0).reshape(height * width)
    rgb = shard_render(params, frame, eval_settings, mesh, spec=spec, chunk=8192)["rgb_fine"]
    _check(tuple(rgb.shape) == (height * width, 3) and bool(torch.isfinite(rgb).all()), "sharded plain render")
    report["plain_shape"] = tuple(rgb.shape)
    before = _launches()
    fused = shard_render(params, frame, eval_settings, mesh, use_fused=True)["rgb_fine"]
    _sync(first)
    report["launches"]["fused"] = _delta(before)
    report["fused_err"] = _max_err(fused, rgb)
    _check(report["fused_err"] < TOLERANCE, f"fused leg diverges from the plain render: {report['fused_err']}")

    def sharded_against_single(name, net_params, leg_settings, leg_quant, grid_hw=None):
        before = _launches()
        sharded = shard_render(net_params, frame, leg_settings, mesh, use_fused=True, quant=leg_quant,
                               grid_hw=grid_hw)["rgb_fine"]
        _sync(first)
        report["launches"][name] = _delta(before)
        kp = replicas(net_params, mesh, fused=True, quant=leg_quant)[first]
        single = fused_render.render_rays_fused(kp, frame, leg_settings, early_stop_eps=1e-3, grid_hw=grid_hw)
        err = _max_err(sharded, single)
        report[f"{name}_err"] = err
        report[f"{name}_bytes_equal"] = bool(np.array_equal(_uint8(sharded), _uint8(single)))
        _check(bool(torch.isfinite(sharded).all()), f"{name}: non-finite sharded render")
        _check(err < TOLERANCE, f"mesh-sharded {name} render diverges from the single-device one: {err}")

    # 3. The serving configuration: the proposal net's density pass and the
    # int8 kernels (JAX :169-226).
    prop_gen = torch.Generator().manual_seed(seed + 4)
    serve = {"proposal": params_from_numpy(init_nerf_params(prop_gen, proposal_spec()), first),
             "fine": params["fine"]}
    serve_settings = eval_settings._replace(use_proposal=True)
    sharded_against_single("serving", serve, serve_settings, calibrate_model_quant(serve, spec))

    # 4. A turbo student: importance-only placement through a narrower net
    # (JAX :228-271), then on the stride-4 lattice (:273-300).
    student_gen = torch.Generator().manual_seed(seed + 5)
    turbo = {"proposal": serve["proposal"],
             "fine": params_from_numpy(init_nerf_params(student_gen, student_spec), first)}
    turbo_settings = serve_settings._replace(merge_coarse=False, n_importance=TURBO_SAMPLES)
    turbo_quant = calibrate_model_quant(turbo, student_spec)
    sharded_against_single("turbo", turbo, turbo_settings, turbo_quant)
    sharded_against_single("stride", turbo, turbo_settings._replace(proposal_subsample=STRIDE), turbo_quant,
                           grid_hw=(height, width))

    # 5. K data-parallel steps a call as graph replays against eager steps.
    graphed = None
    if graph_steps > 0:
        graphed = _graph_leg(report, mesh, spec, train_settings, schedule, seed, rays_d, rgbs_d, gens, n_img,
                             size * size, n_rays, graph_steps)

    if time_reps > 0:
        report["ms"] = _timings(mesh, params, frame, eval_settings, state, shard_params, rays_d, rgbs_d, gens,
                                seeds, train_settings, spec, schedule, rays_train, rgbs, n_rays, time_reps, graphed)

    print(
        f"dryrun_multigpu({n}) OK: train loss {loss:.4f}, sharded render {report['plain_shape']}, "
        f"fused-vs-plain max err {report['fused_err']:.4e}, int8+proposal serving sharded-vs-single max err "
        f"{report['serving_err']:.4e}, turbo ({student_spec.depth}x{student_spec.width} student) sharded-vs-single "
        f"max err {report['turbo_err']:.4e}, strided-placement sharded-vs-single max err {report['stride_err']:.4e}"
        + (f", {GRAPH_CALLS} calls of {graph_steps} graphed data-parallel steps vs eager max |loss diff| "
           f"{report['graph_loss_err']:.1e}" if graph_steps > 0 else ""),
        flush=True,
    )
    return report


def _graph_leg(report, mesh, spec, settings, schedule, seed, rays_d, rgbs_d, gens, n_img, hw, n_rays, k):
    """GRAPH_CALLS calls of K data-parallel steps from a fresh state: eagerly
    (`take_steps` of a `DataParallelBody`), then through a `StepGraph` on
    `cuda` (the first call's warm-up steps and capture, then replays; on the
    CPU `take_steps` again), with the same draws; every loss equal to
    GRAPH_LOSS_ATOL. Adds the losses' max |diff| and the graph's launches
    to the report; returns what the timings go on replaying."""
    first = mesh.devices[0]

    def draws(step):
        shard_seeds = [int(s) for s in np.random.SeedSequence([seed, 6, step]).generate_state(mesh.size)]
        return draw_shards(gens, shard_seeds, seed + 7 + step, n_img, hw, n_rays, settings, mesh)

    calls = [[draws(c * k + i) for i in range(k)] for c in range(GRAPH_CALLS)]
    losses = {}
    for leg in ("eager", "graph"):
        state = init_train_state(spec, schedule, first, seed=seed + 8)
        body = DataParallelBody(state, mesh_replicas(state, mesh), rays_d, rgbs_d, settings, spec, mesh)
        graph = StepGraph(k) if leg == "graph" and first.type == "cuda" else None
        losses[leg] = []
        for c, call in enumerate(calls):
            if c <= 1:
                before = _launches()
            if graph is not None:
                state, metrics = graph(state, body, call, schedule)
            else:
                state, metrics = take_steps(state, body, call, schedule)
            losses[leg].append(metrics["total_loss_steps"])
            if leg == "graph" and c in (0, len(calls) - 1):  # the first call; the replays after it
                _sync(first)
                report["launches"]["train_graph" if c == 0 else "train_graph_replays"] = _delta(before)
    err = max(_max_err(a, b) for a, b in zip(losses["graph"], losses["eager"]))
    report["graph_loss_err"] = err
    _check(state.step == GRAPH_CALLS * k, f"step count {state.step} after {GRAPH_CALLS} calls of {k}")
    _check(err <= GRAPH_LOSS_ATOL, f"graphed data-parallel steps diverge from eager ones: max |loss diff| {err}")
    return dict(state=state, body=body, graph=graph, k=k)


def _timings(mesh, params, frame, settings, state, shard_params, rays_d, rgbs_d, gens, seeds, train_settings,
             spec, schedule, rays_train, rgbs, n_rays, reps, graphed=None) -> Dict[str, float]:
    """Warm ms, the median of `reps` synchronized host-clock readings: the
    fused frame sharded and not; a data-parallel step and a single-device
    step of the same batch size; with `graphed` (the graph leg), a call of
    its K graphed data-parallel steps and one of K graphed single-device
    steps, each over K (on `cuda`)."""
    first = mesh.devices[0]

    def median_ms(fn) -> float:
        fn()
        readings = []
        for _ in range(reps):
            _sync(first)
            t0 = time.perf_counter()
            fn()
            _sync(first)
            readings.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(readings))

    kp = replicas(params, mesh, fused=True)[first]
    out = {
        "frame_sharded": median_ms(lambda: shard_render(params, frame, settings, mesh, use_fused=True)),
        "frame_single": median_ms(lambda: fused_render.render_rays_fused(kp, frame, settings, early_stop_eps=1e-3)),
    }
    n_img, hw = rgbs.shape[0], rgbs.shape[1]
    holder = {"state": state}

    def dp_step():
        draws = draw_shards(gens, seeds, 0, n_img, hw, n_rays, train_settings, mesh)
        holder["state"], _ = data_parallel_step(holder["state"], shard_params, rays_d, rgbs_d, draws,
                                                train_settings, spec, schedule, mesh)

    single_state = init_train_state(spec, schedule, first, seed=1)
    single_gen = torch.Generator(device=first)

    def single_draws():
        return draw_step(single_gen.manual_seed(seeds[0]), n_img, hw, n_rays, train_settings, first)

    def single_step():
        holder["single"], _ = train_step(holder.get("single", single_state), rays_train, rgbs, single_draws(),
                                         train_settings, spec, schedule)

    out["step_sharded"] = median_ms(dp_step)
    out["step_single"] = median_ms(single_step)
    if graphed is not None and graphed["graph"] is not None:
        k = graphed["k"]

        def dp_graph_call():
            draws = [draw_shards(gens, seeds, i, n_img, hw, n_rays, train_settings, mesh) for i in range(k)]
            graphed["state"], _ = graphed["graph"](graphed["state"], graphed["body"], draws, schedule)

        single_graph, graph_state = StepGraph(k), init_train_state(spec, schedule, first, seed=2)
        single_body = functools.partial(apply_step, graph_state, rays_train, rgbs, settings=train_settings, spec=spec)

        def single_graph_call():
            holder["graph_single"], _ = single_graph(holder.get("graph_single", graph_state), single_body,
                                                     [single_draws() for _ in range(k)], schedule)

        out["step_sharded_graph"] = median_ms(dp_graph_call) / k
        out["step_single_graph"] = median_ms(single_graph_call) / k
    return out
