"""mip-NeRF 360's model: its spec, its parameter tree and the seeded draw of
its weights.

Barron et al., CVPR 2022 (arXiv:2111.12077), as google-research/multinerf
serves it (configs/360.gin; internal/models.py `NerfMLP`, `PropMLP`): one
proposal MLP of 4 ReLU layers of width 256, evaluated in two rounds of 64
samples, and a NeRF MLP of 8 ReLU layers of width 1024 over 32 samples,
the encoded Gaussians re-entering after layer index 4, density
softplus(raw - 1), a 256-wide bottleneck without activation beside the
encoded view direction (3 + 3 x 2 x 4 = 27), one ReLU layer of width 128
and rgb = sigmoid(raw) x 1.002 - 0.001. Both nets read the 504 expected
sines of `models.encoding.integrated_pos_enc` (21 directions, degrees
0-11). The frame's pipeline is `ops.mipnerf360.render_rays_mip360`.

A tree is {"prop": {"trunk": [{"w", "b"}, ...], "density"}, "nerf":
{"trunk", "density", "bottleneck", "view", "rgb"}}, weights [in, out].
`init_params` draws it from a seed: each weight U(+-sqrt(6 / fan_in))
(he_uniform, multinerf's init) from numpy's
`default_rng(SeedSequence([seed, net, layer]))`, net 0 the proposal and 1
the NeRF MLP, layers numbered in the order above; biases 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.models.encoding import icosahedron_basis


@dataclasses.dataclass(frozen=True)
class Mip360Spec:
    nerf_depth: int = 8
    nerf_width: int = 1024
    skip: int = 4  # the encoding re-enters after this trunk layer
    bottleneck: int = 256
    view_width: int = 128
    view_degrees: int = 4
    prop_depth: int = 4
    prop_width: int = 256
    prop_samples: Tuple[int, int] = (64, 64)
    nerf_samples: int = 32
    basis_subdivisions: int = 2
    n_degrees: int = 12
    dilation_bias: float = 0.0025
    dilation_multiplier: float = 0.5
    near: float = 0.1
    far: float = 1e6
    scene_scale: float = 5.0

    @property
    def n_basis(self) -> int:
        return len(basis(self.basis_subdivisions))

    @property
    def enc_dim(self) -> int:
        return 2 * self.n_degrees * self.n_basis

    @property
    def view_dim(self) -> int:
        return 3 + 6 * self.view_degrees

    def layer_shapes(self) -> Dict[str, List[Tuple[str, int, int]]]:
        """{net: [(name, fan_in, fan_out)]} in the draw's order."""
        e, w, p = self.enc_dim, self.nerf_width, self.prop_width
        prop = [(f"trunk{i}", e if i == 0 else p, p) for i in range(self.prop_depth)] + [("density", p, 1)]
        nerf = [(f"trunk{i}", e if i == 0 else w + (e if i == self.skip + 1 else 0), w)
                for i in range(self.nerf_depth)]
        nerf += [("density", w, 1), ("bottleneck", w, self.bottleneck),
                 ("view", self.bottleneck + self.view_dim, self.view_width), ("rgb", self.view_width, 3)]
        return {"prop": prop, "nerf": nerf}

    def to_dict(self) -> Dict[str, Any]:
        return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Mip360Spec":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown mip-NeRF 360 spec keys {unknown}")
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


_BASES: Dict[int, np.ndarray] = {}


def basis(subdivisions: int = 2) -> np.ndarray:
    """The encoding's directions, float64 [n, 3] (cached)."""
    if subdivisions not in _BASES:
        _BASES[subdivisions] = icosahedron_basis(subdivisions)
    return _BASES[subdivisions]


NETS = ("prop", "nerf")


def init_params(seed: int, spec: Mip360Spec) -> Dict[str, Dict[str, Any]]:
    """The seeded tree (module note), float32 numpy arrays."""
    tree: Dict[str, Dict[str, Any]] = {}
    for net_id, net in enumerate(NETS):
        layers = {}
        for layer_id, (name, fan_in, fan_out) in enumerate(spec.layer_shapes()[net]):
            rng = np.random.default_rng(np.random.SeedSequence([int(seed), net_id, layer_id]))
            lim = np.sqrt(6.0 / fan_in)
            layers[name] = {"w": rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32),
                            "b": np.zeros(fan_out, np.float32)}
        trunk = sorted((k for k in layers if k.startswith("trunk")), key=lambda k: int(k[5:]))
        tree[net] = {"trunk": [layers.pop(k) for k in trunk], **layers}
    return tree


def params_to_torch(tree: Dict[str, Dict[str, Any]], device) -> Dict[str, Dict[str, Any]]:
    """The tree's arrays as float32 tensors on `device`."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return torch.as_tensor(np.asarray(node, np.float32), device=device)

    return conv(tree)


def view_encoding(viewdirs: torch.Tensor, degrees: int) -> torch.Tensor:
    """Unit directions [..., 3] -> [..., 3 + 6 degrees]: the direction, then
    sin(2^l d) for l < degrees (degree-major), then the cosines (multinerf
    coord.pos_enc with the identity appended first)."""
    scales = 2.0 ** torch.arange(degrees, dtype=viewdirs.dtype, device=viewdirs.device)
    xb = (viewdirs[..., None, :] * scales[:, None]).flatten(-2)
    return torch.cat([viewdirs, torch.sin(xb), torch.cos(xb)], -1)
