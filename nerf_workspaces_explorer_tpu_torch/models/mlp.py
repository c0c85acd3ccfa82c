"""The NeRF MLP as an `nn.Module` over the JAX package's parameter tree.

Counterpart of `nerf_workspaces_explorer_tpu/models/mlp.py` (reference
nerf/models/nerf_model.py:10-83): D=8 ReLU layers of width W=256, the encoded
position re-concatenated as `[input_pts, h]` after layer index 4, then the
activation-free alpha and feature heads, one view layer (W+27 -> W//2, ReLU)
and the rgb head. Weights keep the tree's [in, out] layout, so a tree loaded
from either package's checkpoints drops in without transposes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

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


class Dense(nn.Module):
    """y = x @ w + b with w stored [in, out] (the tree's layout)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor) -> None:
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)

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

    def forward(
        self, encoded_pts: torch.Tensor, encoded_views: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[..., input_ch] (+ [..., input_ch_views]) -> raw [..., 4] = [rgb, sigma]."""
        h = encoded_pts
        for i, layer in enumerate(self.pts):
            h = torch.relu(layer(h))
            if i in self.spec.skips:
                h = torch.cat([encoded_pts, h], dim=-1)
        if not self.spec.use_view_dirs:
            return self.output(h)
        if encoded_views is None:
            raise ValueError("use_view_dirs=True requires encoded_views")
        alpha = self.alpha(h)
        h = torch.cat([self.feature(h), encoded_views], dim=-1)
        for layer in self.views:
            h = torch.relu(layer(h))
        return torch.cat([self.rgb(h), alpha], dim=-1)
