"""The NeRF MLP over the JAX package's parameter tree.

Counterpart of `nerf_workspaces_explorer_tpu/models/mlp.py` (reference
nerf/models/nerf_model.py:10-83): D=8 ReLU layers of width W=256, the encoded
position re-concatenated as `[input_pts, h]` after layer index 4, then the
activation-free alpha and feature heads, one view layer (W+27 -> W//2, ReLU)
and the rgb head. Weights keep the tree's [in, out] layout, so a tree loaded
from either package's checkpoints drops in without transposes.

A tree is nested dicts and lists of tensors, {"pts": [{"w", "b"}, ...],
"feature", "alpha", "views": [...], "rgb"}. Training differentiates the
tree's leaf tensors directly (`apply_nerf_mlp`); `NerfMLP` holds one tree as
an `nn.Module`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import torch
from torch import nn

Params = Dict[str, Any]


class NerfMLPSpec(NamedTuple):
    """Static architecture description."""

    depth: int = 8
    width: int = 256
    input_ch: int = 63
    input_ch_views: int = 27
    skips: tuple = (4,)
    use_view_dirs: bool = True
    output_ch: int = 4  # only used when use_view_dirs=False

    def layer_dims(self):
        """[(in, out)] for the density trunk (reference nerf_model.py:32-34)."""
        dims = [(self.input_ch, self.width)]
        for i in range(self.depth - 1):
            in_dim = self.width + self.input_ch if i in self.skips else self.width
            dims.append((in_dim, self.width))
        return dims


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the JAX package's flatten order: dict keys sorted, lists in
    order (also the `||` key order of the `.npz` checkpoints)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """The tree shaped like `template` with `leaves` in `tree_leaves` order."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def _init_linear(gen: torch.Generator, in_dim: int, out_dim: int, device) -> Dict[str, torch.Tensor]:
    """Torch-style nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in)) for both
    weight and bias, weight drawn first."""
    bound = 1.0 / math.sqrt(in_dim)
    w = (torch.rand((in_dim, out_dim), generator=gen, device=device) * 2.0 - 1.0) * bound
    b = (torch.rand((out_dim,), generator=gen, device=device) * 2.0 - 1.0) * bound
    return {"w": w, "b": b}


def init_nerf_params(
    gen: torch.Generator, spec: NerfMLPSpec, device: torch.device | str = "cpu"
) -> Params:
    """A fresh parameter tree for one NeRF MLP from `gen` (JAX package
    `init_nerf_params`, mlp.py:53-90; the draws differ from jax.random's)."""
    params: Params = {
        "pts": [_init_linear(gen, i, o, device) for i, o in spec.layer_dims()]
    }
    if spec.use_view_dirs:
        params["feature"] = _init_linear(gen, spec.width, spec.width, device)
        params["alpha"] = _init_linear(gen, spec.width, 1, device)
        params["views"] = [
            _init_linear(gen, spec.width + spec.input_ch_views, spec.width // 2, device)
        ]
        params["rgb"] = _init_linear(gen, spec.width // 2, 3, device)
    else:
        params["output"] = _init_linear(gen, spec.width, spec.output_ch, device)
    return params


def _linear(layer: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ layer["w"] + layer["b"]


def apply_nerf_mlp(
    params: Params,
    spec: NerfMLPSpec,
    encoded_pts: torch.Tensor,
    encoded_views: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[..., input_ch] (+ [..., input_ch_views]) -> raw [..., 4] = [rgb, sigma],
    differentiable in the tree's leaves (JAX `apply_nerf_mlp`)."""
    h = encoded_pts
    for i, layer in enumerate(params["pts"]):
        h = torch.relu(_linear(layer, h))
        if i in spec.skips:
            h = torch.cat([encoded_pts, h], dim=-1)
    if not spec.use_view_dirs:
        return _linear(params["output"], h)
    if encoded_views is None:
        raise ValueError("use_view_dirs=True requires encoded_views")
    alpha = _linear(params["alpha"], h)
    h = torch.cat([_linear(params["feature"], h), encoded_views], dim=-1)
    for layer in params["views"]:
        h = torch.relu(_linear(layer, h))
    return torch.cat([_linear(params["rgb"], h), alpha], dim=-1)


class Dense(nn.Module):
    """y = x @ w + b with w stored [in, out] (the tree's layout)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor) -> None:
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _dense(layer: Dict[str, torch.Tensor]) -> Dense:
    return Dense(layer["w"], layer["b"])


class NerfMLP(nn.Module):
    """Applies one parameter tree {pts, feature, alpha, views, rgb}."""

    def __init__(self, params: Params, spec: NerfMLPSpec) -> None:
        super().__init__()
        self.spec = spec
        self.pts = nn.ModuleList(_dense(layer) for layer in params["pts"])
        if spec.use_view_dirs:
            self.feature = _dense(params["feature"])
            self.alpha = _dense(params["alpha"])
            self.views = nn.ModuleList(_dense(layer) for layer in params["views"])
            self.rgb = _dense(params["rgb"])
        else:
            self.output = _dense(params["output"])

    def tree(self) -> Params:
        """The module's parameters as a tree (the tensors themselves)."""
        layer = lambda d: {"w": d.w, "b": d.b}  # noqa: E731
        if not self.spec.use_view_dirs:
            return {"pts": [layer(d) for d in self.pts], "output": layer(self.output)}
        return {
            "pts": [layer(d) for d in self.pts],
            "feature": layer(self.feature),
            "alpha": layer(self.alpha),
            "views": [layer(d) for d in self.views],
            "rgb": layer(self.rgb),
        }

    def forward(
        self, encoded_pts: torch.Tensor, encoded_views: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[..., input_ch] (+ [..., input_ch_views]) -> raw [..., 4] = [rgb, sigma]."""
        return apply_nerf_mlp(self.tree(), self.spec, encoded_pts, encoded_views)
