"""Proposal-network sampling: the architecture of the small density net that
takes the coarse pass's place.

Counterpart of `nerf_workspaces_explorer_tpu/render/proposal.py`
(`proposal_spec`, proposal.py:26-40). The proposal net replaces the coarse
8x256 net, whose only inference-time product is the importance weights, by a
2x64 net; its view and rgb heads exist so that it shares the fused kernels'
layout, and no inference path evaluates them. The interlevel loss that
trains it is not ported yet.
"""

from __future__ import annotations

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
