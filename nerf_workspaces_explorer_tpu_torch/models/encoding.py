"""Sinusoidal positional encoding.

Counterpart of `nerf_workspaces_explorer_tpu/models/encoding.py` (reference
nerf/models/embedding.py:6-48): x -> [x, sin(2^0 x), cos(2^0 x), ...,
sin(2^(F-1) x), cos(2^(F-1) x)] with the input pre-divided by
`scalar_factor`. 3D locations use F=10, factor=10 (-> 63 dims); view
directions use F=4, factor=1 (-> 27 dims). The interleaved per-frequency
[sin_f, cos_f] order is the reference's, so checkpoints load unchanged.
"""

from __future__ import annotations

import torch


def embedding_output_dim(num_freqs: int, input_dims: int = 3) -> int:
    """Output dim: identity + (sin, cos) per frequency per input dim."""
    return input_dims * (1 + 2 * num_freqs)


def positional_encoding(
    x: torch.Tensor, num_freqs: int, scalar_factor: float = 1.0
) -> torch.Tensor:
    """Encode [..., D] -> [..., D * (1 + 2 * num_freqs)]."""
    x = x / scalar_factor
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]  # [..., F, D]
    sincos = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    return torch.cat([x, sincos.reshape(*x.shape[:-1], -1)], dim=-1)
