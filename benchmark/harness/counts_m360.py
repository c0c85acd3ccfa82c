"""Operations and bytes that a mip-NeRF 360 frame needs, from the seeded
checkpoint's spec (`reference/mipnerf360.py`'s layer shapes), every sample
evaluated, and the card's published peaks (`harness/counts.py`).

Per sample, the proposal MLP's trunk and density head (two rounds of
`prop_samples`), and the NeRF MLP's trunk (the encoding re-entering after
`skip`), density head, bottleneck, the view layer's product with the
bottleneck and the rgb head; per ray, the view layer's product with the
encoded view direction, which is the same for every sample of a ray (the
program computes it once a ray). Kernel names: `csrc/mipnerf360.cu`'s K11
instances, `linear_kernel<BN, EPI, KT>`, the proposal MLP's (one launch) EPI 5.
"""

from __future__ import annotations

from typing import Tuple

from harness import counts, trace
from reference import mipnerf360 as ref

PROP_EPIS = ("5",)
NERF_EPIS = ("0", "1", "3", "4")


def spec_of(config: dict) -> dict:
    """The spec of the configuration's seeded checkpoint."""
    import json
    import os

    from harness.manifest import ROOT

    with open(os.path.join(ROOT, config["serve"]["checkpoint"])) as f:
        return dict(json.load(f)["spec"])


def macs(spec: dict) -> Tuple[int, int, int]:
    """(proposal per sample, NeRF per sample, NeRF per ray) multiply-adds."""
    shapes = ref.layer_shapes(spec)
    prop = sum(i * o for _, i, o in shapes["prop"])
    view_dim = 3 + 6 * spec["view_degrees"]
    nerf = sum(i * o for name, i, o in shapes["nerf"] if name != "view") + spec["bottleneck"] * spec["view_width"]
    return prop, nerf, view_dim * spec["view_width"]


def prop_flops(spec: dict, rays: int) -> float:
    return 2.0 * macs(spec)[0] * sum(spec["prop_samples"]) * rays


def nerf_flops(spec: dict, rays: int) -> float:
    _, per_sample, per_ray = macs(spec)
    return 2.0 * (per_sample * spec["nerf_samples"] + per_ray) * rays


def weight_bytes(spec: dict, net: str) -> int:
    """A net's weights in bf16 and biases in float32, each read once."""
    return sum(i * o * 2 + o * 4 for _, i, o in ref.layer_shapes(spec)[net])


def pass_bound_s(spec: dict, net: str, rays: int) -> float:
    """The least time the card could take for a frame's pass of one net:
    its operations at the bf16 peak, or its bytes (each ray's origin,
    direction, radius and the level's edges read once, its densities or
    colour written once, the weights read once), whichever is larger."""
    if net == "prop":
        flops = prop_flops(spec, rays)
        nbytes = sum(rays * 4 * (7 + n + 1 + n) for n in spec["prop_samples"]) + weight_bytes(spec, "prop")
    else:
        flops = nerf_flops(spec, rays)
        n = spec["nerf_samples"]
        nbytes = rays * 4 * (10 + n + 1 + 4 * n) + weight_bytes(spec, "nerf")
    return counts.bound_s(flops, nbytes)[0]


def kernel_s(tr: trace.Trace, net: str) -> float:
    """Traced seconds of one net's K11 launches."""
    epis = PROP_EPIS if net == "prop" else NERF_EPIS
    us = 0.0
    for op in trace.kernels(tr):
        args = trace.template_args(op.name) if op.name.startswith("linear_kernel<") else []
        if len(args) > 1 and args[1] in epis:
            us += op.dur_us
    return us * 1e-6
