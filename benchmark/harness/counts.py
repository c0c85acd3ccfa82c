"""Operations and bytes that a frame's work needs, from the configuration's
shapes and the samples the inputs need, and the card's published peaks.

The per-sample and per-ray multiply-adds follow the layer equations of a
NeRF MLP (NeRF, arXiv:2003.08934, App. A): the trunk of `depth` ReLU layers
of `width` (the encoded position re-enters at the skip layer), the density
head, and for a colour the feature layer, the view layer of width / 2 on
[feature, encoded view direction] and the rgb head. The view layer's
product with the encoded view direction is the same for every sample of a
ray, so it is counted once a ray (as the render kernel computes it).
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM, data sheet: dense bf16 tensor rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES_PER_S = 3.35e12


def enc_dim(num_freqs: int) -> int:
    return 3 * (1 + 2 * num_freqs)


def trunk_macs(net: dict) -> int:
    """Multiply-adds of the trunk and the density head, per sample."""
    w, d_in = net["width"], enc_dim(net["pts_freqs"])
    macs = d_in * w
    for i in range(1, net["depth"]):
        macs += (w + d_in if (i - 1) in net["skips"] else w) * w
    return macs + w


def colour_macs(net: dict) -> Tuple[int, int]:
    """(per sample, per ray) multiply-adds of the colour branch."""
    w, half = net["width"], net["width"] // 2
    return w * w + w * half + half * 3, enc_dim(net["view_freqs"]) * half


def weight_bytes(net: dict, bytes_per_weight: int = 2) -> int:
    """The net's weights in the served type, biases in float32, each read once."""
    w, half = net["width"], net["width"] // 2
    weights = trunk_macs(net) + w * w + (w + enc_dim(net["view_freqs"])) * half + half * 3
    biases = net["depth"] * w + 1 + w + half + 3
    return weights * bytes_per_weight + biases * 4


def pass_flops(net: dict, samples: int, rays: int, colour: bool) -> float:
    """2 x multiply-adds of one pass over `samples` needed samples of `rays` rays."""
    per_sample = trunk_macs(net)
    per_ray = 0
    if colour:
        c_sample, per_ray = colour_macs(net)
        per_sample += c_sample
    return 2.0 * (per_sample * samples + per_ray * rays)


def fine_pass_bytes(net: dict, samples_per_ray: int, rays: int) -> int:
    """Each ray's origin, direction, view direction and depths read once, its
    colour written once, and the weights read once."""
    return rays * (4 * (3 + 3 + 3 + samples_per_ray) + 4 * 3) + weight_bytes(net)


def train_forward_flops(config: dict) -> float:
    """One training step's forward operations, coarse and fine nets, over
    every sample of its rays (training evaluates them all)."""
    train, nets = config["train"], config["nets"]
    rays, s, i = int(train["n_rays"]), int(train["n_samples"]), int(train["n_importance"])
    return pass_flops(nets["coarse"], rays * s, rays, True) + pass_flops(nets["fine"], rays * (s + i), rays, True)


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
