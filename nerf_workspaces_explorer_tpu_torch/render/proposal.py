"""Proposal-network sampling: the small density net that takes the coarse
pass's place, and the interlevel loss that trains it.

Counterpart of `nerf_workspaces_explorer_tpu/render/proposal.py`. The
proposal net replaces the coarse 8x256 net, whose only inference-time
product is the importance weights, by a 2x64 net (`proposal_spec`,
proposal.py:26-40); its view and rgb heads exist so that it shares the fused
kernels' layout, and no inference path evaluates them (in training they get
zero gradient). It is trained so that its weight histogram bounds the fine
net's from above: the interlevel loss of mip-NeRF 360 (Barron et al., CVPR
2022, Eq. 13; JAX proposal.py:43-122).

The loss is gather-free, as the JAX package's: the histogram bound is a
masked max over [R, P, F] of sorted prefix sums. It makes no host sync, so a
CUDA graph of the training step holds it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec


def proposal_spec(num_freqs_3d: int = 6, width: int = 64, depth: int = 2) -> NerfMLPSpec:
    """The proposal net: `depth` x `width`, no skip, `num_freqs_3d` point
    and 2 view frequencies."""
    return NerfMLPSpec(
        depth=depth,
        width=width,
        input_ch=3 * (1 + 2 * num_freqs_3d),
        input_ch_views=3 * (1 + 2 * 2),
        skips=(),
        use_view_dirs=True,
    )


def _sample_edges(z_vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample interval edges: midpoints between samples, clamped at the
    first and last sample (JAX `_sample_edges`)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    lower = torch.cat([z_vals[..., :1], mids], -1)
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    return lower, upper


def _masked_max(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """max over the last axis of values[..., None, :] where mask [..., P, F]
    holds, 0 where it holds nowhere (the values are non-negative sums)."""
    neg = torch.full((), float("-inf"), dtype=values.dtype, device=values.device)
    return torch.clamp(torch.where(mask, values[..., None, :], neg).amax(-1), min=0.0)


def _cumweight_at(fine_upper: torch.Tensor, fine_cum: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """W(q): the fine weight of the intervals wholly below q, the largest
    inclusive prefix sum over {i: upper_i <= q} (prefix sums never
    decrease). fine_upper, fine_cum [..., F]; query [..., P]."""
    return _masked_max(fine_upper[..., None, :] <= query[..., :, None], fine_cum)


def _suffix_weight(fine_lower: torch.Tensor, w_fine: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """The fine weight of the intervals with lower edge >= q, the largest
    suffix sum over that set (suffix sums never increase in i)."""
    rev_cum = torch.flip(torch.cumsum(torch.flip(w_fine, [-1]), -1), [-1])
    return _masked_max(fine_lower[..., None, :] >= query[..., :, None], rev_cum)


def interlevel_loss(
    z_prop: torch.Tensor,
    w_prop: torch.Tensor,
    z_fine: torch.Tensor,
    w_fine: torch.Tensor,
    *,
    eps: float = 1e-7,
) -> torch.Tensor:
    """mean over bins of max(0, bound - w_prop)^2 / (w_prop + eps), where
    bound is the fine weight of the intervals that overlap the proposal bin
    (JAX `interlevel_loss`). The fine side is the target: detached, so the
    gradient reaches the proposal's weights only.

    z_prop, w_prop: [..., P] proposal depths (sorted) and weights; z_fine,
    w_fine: [..., F] fine depths (sorted) and weights."""
    w_fine, z_fine = w_fine.detach(), z_fine.detach()
    prop_lower, prop_upper = _sample_edges(z_prop)
    fine_lower, fine_upper = _sample_edges(z_fine)
    # The intervals that intersect [lower, upper]: those started before
    # upper, less those finished by lower.
    cum = torch.cumsum(w_fine, -1)
    started_before = cum[..., -1:] - _suffix_weight(fine_lower, w_fine, prop_upper)
    finished_by = _cumweight_at(fine_upper, cum, prop_lower)
    bound = torch.clamp(started_before - finished_by, min=0.0)
    excess = torch.clamp(bound - w_prop, min=0.0)
    return torch.mean(excess**2 / (w_prop + eps))
