"""Ray-sharded rendering over a device mesh.

Counterpart of `nerf_workspaces_explorer_tpu/parallel/sharding.py`, whose
`shard_map` splits the flat ray axis over the mesh: rays have no data
dependencies on each other, so each device renders a contiguous shard with
the same pipeline and the frame is gathered at the end. Here the shards run
in order from the host: on each shard's device (under `torch.cuda.device`,
since a kernel launches on the calling thread's current device), every
shard launched before any output is copied back, then the outputs
concatenated on the mesh's first device. The weights are replicated once
per distinct device and kept for later calls (`replicas`): the parameter
trees of the plain leg; the fused leg's `KernelParams`, with the weight
stream packed once and copied (`ops/fused_render.py::
replicate_kernel_params`). A mesh that repeats one device (the CPU tests'
`["cpu"] * 8`, `[cuda:0] * k`) shares one replica.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec
from nerf_workspaces_explorer_tpu_torch.ops.fused_render import (
    KernelParams,
    prepare_kernel_params,
    render_rays_fused,
    replicate_kernel_params,
)
from nerf_workspaces_explorer_tpu_torch.ops.quantize import spec_from_net_params
from nerf_workspaces_explorer_tpu_torch.parallel.mesh import DataMesh
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.render.pipeline import (
    RenderSettings,
    render_ray_bundle,
    render_rays_chunked,
)

# Replicas of recent weight sets: (id of the weights, fused, id of quant) ->
# (the weights, quant, {device: replica}). Each entry holds its weights and
# calibration, so an id is not reused while it is cached.
_REPLICAS: Dict[Tuple[int, bool, int], Tuple[Any, Any, Dict[torch.device, Any]]] = {}
_REPLICAS_KEPT = 16


def on_device(device: torch.device):
    """The context a shard's work runs in: its card current, or nothing."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def tree_to(tree: Any, device: torch.device) -> Any:
    """A tree of tensors (or KernelParams) copied to `device`."""
    if isinstance(tree, KernelParams):
        return replicate_kernel_params(tree, device)
    if isinstance(tree, Mapping):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a RayBundle
        return type(tree)(*(tree_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _is_kernel_params(params: Mapping[str, Any]) -> bool:
    return all(isinstance(v, KernelParams) for v in params.values())


def replicas(params: Mapping[str, Any], mesh: DataMesh, *, fused: bool = False,
             quant: Optional[Mapping[str, Any]] = None) -> Dict[torch.device, Any]:
    """{device: the weights there} for each distinct device of the mesh,
    made at the first call for these weights and reused after it. With
    `fused`, the weights are prepared `KernelParams` (built here from
    parameter trees, with `quant` where given) on the first device and
    copied to the others."""
    key = (id(params), fused, id(quant))
    hit = _REPLICAS.pop(key, None)
    if hit is None or hit[0] is not params or hit[1] is not quant:
        hit = (params, quant, {})
    _REPLICAS[key] = hit  # most recent last
    while len(_REPLICAS) > _REPLICAS_KEPT:
        del _REPLICAS[next(iter(_REPLICAS))]
    by_device = hit[2]
    first = mesh.devices[0]
    if first not in by_device:
        with on_device(first):
            if fused and not _is_kernel_params(params):
                tree = tree_to(params, first)
                by_device[first] = {
                    k: prepare_kernel_params(p, spec_from_net_params(p), quant=(quant or {}).get(k))
                    for k, p in tree.items()
                }
            else:
                by_device[first] = tree_to(params, first)
    for device in mesh.distinct_devices:
        if device not in by_device:
            with on_device(device):
                by_device[device] = tree_to(by_device[first], device)
    return by_device


@torch.no_grad()
def shard_render(
    params: Mapping[str, Any],
    rays: RayBundle,
    settings: RenderSettings,
    mesh: DataMesh,
    *,
    spec: Optional[NerfMLPSpec] = None,
    chunk: int = 8192,
    full_outputs: bool = False,
    use_fused: bool = False,
    quant: Optional[Mapping[str, Any]] = None,
    early_stop_eps: float = 1e-3,
    sort_rays: bool = False,
    grid_hw: Optional[tuple] = None,
) -> Dict[str, torch.Tensor]:
    """Render a flat RayBundle [N] with its rays sharded over the mesh (JAX
    sharding.py:30-121).

    params: {"coarse" or "proposal", "fine"} parameter trees (or NerfMLP
      tensors' trees) of architecture `spec`; for the fused leg also
      prepared `KernelParams`.
    rays: padded by repeating the last ray so that each device gets a
      contiguous shard of ceil(N / n) rays; the padding is stripped.
    chunk: the plain leg's tile: a shard of at most `chunk` rays renders in
      one `render_ray_bundle` call, a larger one through
      `render_rays_chunked`.
    use_fused: each shard through `render_rays_fused` (the density pass,
      placement and fine pass kernels on the card; JAX's `use_pallas`),
      with `quant` (ops/quantize.py) calibrating parameter trees to int8
      and `early_stop_eps`, `sort_rays` as there.
    grid_hw: (rows, cols) of the flat ray axis, for the fused leg's
      placement lattice (`settings.proposal_subsample`): each shard is a
      contiguous block of rows, so its grid is (rows / n, cols) when the
      rays split evenly and the rows divide by n; otherwise the shards
      place every ray exactly.
    Returns the output dict with leading dim N on the mesh's first device:
    the plain leg's names, or the fused leg's rgb/depth/acc/disp `_fine`.
    """
    n_dev = mesh.size
    n = rays.origins.shape[0]
    shard = -(-n // n_dev)
    padded = shard * n_dev
    shard_grid = None
    if grid_hw is not None and padded == n:
        rows, cols = int(grid_hw[0]), int(grid_hw[1])
        if rows * cols == n and rows % n_dev == 0:
            shard_grid = (rows // n_dev, cols)

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x[-1:].expand(padded - n, *x.shape[1:])], 0) if padded > n else x

    rays_padded = RayBundle(*(pad(f) for f in rays))
    weights = replicas(params, mesh, fused=use_fused, quant=quant)
    outs = []
    for i, device in enumerate(mesh.devices):
        with on_device(device):
            local = RayBundle(*(f[i * shard : (i + 1) * shard].to(device) for f in rays_padded))
            if use_fused:
                out = render_rays_fused(weights[device], local, settings, early_stop_eps=early_stop_eps,
                                        full=True, sort_rays=sort_rays, grid_hw=shard_grid)
                outs.append({"rgb_fine": out.rgb, "depth_fine": out.depth[:, None], "acc_fine": out.acc[:, None],
                             "disp_fine": out.disp[:, None]})
            elif shard <= chunk:
                outs.append(render_ray_bundle(weights[device], local, settings.for_eval(), spec=spec,
                                              full_outputs=full_outputs))
            else:
                outs.append(render_rays_chunked(weights[device], local, settings, spec=spec, chunk=chunk,
                                                full_outputs=full_outputs))
    first = mesh.devices[0]
    return {k: torch.cat([o[k].to(first) for o in outs], 0)[:n] for k in outs[0]}
