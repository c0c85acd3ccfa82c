"""Checkpoints: the native `.npz` (save and load) and the reference's torch
`.ckpt` (load and export).

Counterpart of `nerf_workspaces_explorer_tpu/infer/checkpoint.py`. Two
formats load:

  - the native `.npz`: path-flattened arrays under `||`-joined keys
    (`params||fine||pts||0||w`) plus a `__meta__` JSON blob, and, from a
    training run, the optimizer's leaves under `opt||i` (optax.adam's
    flattened state: count, first moments, second moments, count). Both
    packages write and read it;
  - the reference's torch `.ckpt` (`network_coarse_state_dict`,
    `network_fine_state_dict`; reference
    nerf/training/nerf_replica_training_handler.py:404-407), whose keys may
    or may not carry the `_` attribute prefix (the reference re-prefixes
    them on load, …inference_handler.py:150-164) and whose nn.Linear weights
    are [out, in] and transpose to the tree's [in, out].

A tree is nested dicts and lists of tensors:
{"coarse": {"pts": [{"w", "b"}, ...], "feature", "alpha", "views", "rgb"},
"fine": {...}}, or "proposal" in place of "coarse" for a proposal-mode
checkpoint, whose nets have different architectures (a 2x64 proposal net
beside an 8x256 fine net or a narrow student): `params_from_numpy` carries
any such tree, and each net's spec comes from its own shapes
(`ops/quantize.py::spec_from_net_params`).

A third, `.json`, holds no arrays: mip-NeRF 360's seeded checkpoint
(`load_seeded_checkpoint`), its format tag, a seed and the spec, whose
weights `models.mipnerf360.init_params` draws from the seed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

_SEP = "||"


def _unflatten(flat: Mapping[str, np.ndarray]) -> Any:
    """Nested dict/list tree from `||`-joined key paths (digit parts index lists)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def fixup(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fixup(node[str(i)]) for i in range(len(node))]
        return {k: fixup(v) for k, v in node.items()}

    return fixup(root)


def params_from_numpy(
    tree: Any,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
    *,
    requires_grad: bool = False,
) -> Any:
    """Carry a parameter tree of arrays (a JAX tree through `np.asarray`, a
    JAX TrainState's params, or a loaded `.npz`) into torch tensors on
    `device`; with `requires_grad`, leaf tensors a training state can own."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device, dtype, requires_grad=requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype, requires_grad=requires_grad) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    arr = np.asarray(tree, dtype=np.float32)
    out = torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)
    return out.requires_grad_(True) if requires_grad else out


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """`||`-joined key paths, dict keys sorted, as the JAX package writes them."""
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}{k}{_SEP}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}{i}{_SEP}")]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return [(prefix[: -len(_SEP)], np.asarray(tree))]


def save_checkpoint(
    path: str,
    params: Any,
    *,
    step: int = 0,
    opt_leaves: Optional[List[np.ndarray]] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Save a parameter tree (tensors or arrays) and optionally the
    optimizer's leaves as a native `.npz` (JAX `save_checkpoint`)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = dict(_flatten({"params": params}))
    for i, leaf in enumerate(opt_leaves or []):
        arrays[f"opt{_SEP}{i}"] = np.asarray(leaf)
    meta = dict(metadata or {})
    meta["step"] = int(step)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_training_checkpoint(
    path: str,
) -> Tuple[Dict[str, np.ndarray], int, List[np.ndarray], Dict[str, Any]]:
    """Load a native `.npz` -> (params tree of numpy arrays, step, optimizer
    leaves in `opt||i` order (empty if none), metadata)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays.pop("__meta__").tobytes()).decode())
    step = int(meta.pop("step", 0))
    opt_keys = sorted((k for k in arrays if k.startswith(f"opt{_SEP}")),
                      key=lambda k: int(k.split(_SEP)[1]))
    opt_leaves = [arrays.pop(k) for k in opt_keys]
    return _unflatten(arrays)["params"], step, opt_leaves, meta


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int, Dict[str, Any]]:
    """Load a native `.npz` -> (params tree of numpy arrays, step, metadata)."""
    params, step, _, meta = load_training_checkpoint(path)
    return params, step, meta


def torch_state_dict_to_params(state_dict: Mapping[str, Any]) -> Params:
    """One reference NeRFModel state dict -> parameter tree of numpy arrays."""
    norm: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        parts = [p[1:] if p.startswith("_") else p for p in key.split(".")]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        norm[".".join(parts)] = np.asarray(value)

    def linear(name: str) -> Dict[str, np.ndarray]:
        return {"w": norm[f"{name}.weight"].T, "b": norm[f"{name}.bias"]}

    def count(prefix: str) -> int:
        return len({k.split(".")[1] for k in norm if k.startswith(prefix + ".")})

    params: Params = {"pts": [linear(f"pts_linears.{i}") for i in range(count("pts_linears"))]}
    if "alpha_linear.weight" in norm:
        params["alpha"] = linear("alpha_linear")
        params["feature"] = linear("feature_linear")
        params["views"] = [
            linear(f"views_linears.{i}") for i in range(count("views_linears"))
        ]
        params["rgb"] = linear("rgb_linear")
    else:
        params["output"] = linear("output_linear")
    return params


def params_to_torch_state_dict(params: Params, *, underscore: bool = True) -> Dict[str, np.ndarray]:
    """One net's parameter tree (tensors or arrays) -> the reference's state
    dict layout, numpy values: nn.Linear weights [out, in], keys with the
    `_` attribute prefix unless `underscore` is False (JAX
    infer/checkpoint.py:165-188)."""
    prefix = "_" if underscore else ""
    out: Dict[str, np.ndarray] = {}

    def put(name: str, layer: Mapping[str, Any]) -> None:
        w, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in (layer["w"], layer["b"]))
        out[f"{prefix}{name}.weight"] = w.T.copy()
        out[f"{prefix}{name}.bias"] = b.copy()

    for i, layer in enumerate(params["pts"]):
        put(f"pts_linears.{i}", layer)
    if "alpha" in params:
        put("alpha_linear", params["alpha"])
        put("feature_linear", params["feature"])
        for i, layer in enumerate(params["views"]):
            put(f"views_linears.{i}", layer)
        put("rgb_linear", params["rgb"])
    else:
        put("output_linear", params["output"])
    return out


def save_torch_checkpoint(path: str, coarse: Params, fine: Params, *, step: int = 0) -> None:
    """Export a reference-format torch checkpoint (…training_handler.py:
    404-407), which the reference application and `load_torch_checkpoint`
    load (JAX infer/checkpoint.py:191-212)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(
        {
            "global_step": int(step),
            "network_coarse_state_dict": {
                k: torch.from_numpy(v) for k, v in params_to_torch_state_dict(coarse).items()
            },
            "network_fine_state_dict": {
                k: torch.from_numpy(v) for k, v in params_to_torch_state_dict(fine).items()
            },
            "optimizer_state_dict": {},
        },
        path,
    )


def load_torch_checkpoint(path: str) -> Tuple[Params, Params, int]:
    """Reference-format torch checkpoint -> (coarse, fine, step), numpy trees."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    coarse = torch_state_dict_to_params(checkpoint["network_coarse_state_dict"])
    fine = torch_state_dict_to_params(checkpoint["network_fine_state_dict"])
    return coarse, fine, int(checkpoint.get("global_step", 0))


SEEDED_FORMAT = "mipnerf360-seeded"


def load_seeded_checkpoint(path: str):
    """A seeded `.json` checkpoint -> (tree of numpy arrays, Mip360Spec, its
    fields): {"format": "mipnerf360-seeded", "seed": n, "spec": {...}}."""
    from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import Mip360Spec, init_params

    with open(path) as f:
        meta = json.load(f)
    if meta.get("format") != SEEDED_FORMAT:
        raise ValueError(f"{path}: not a {SEEDED_FORMAT} checkpoint (format {meta.get('format')!r})")
    spec = Mip360Spec.from_dict(meta.get("spec", {}))
    return init_params(int(meta["seed"]), spec), spec, meta
