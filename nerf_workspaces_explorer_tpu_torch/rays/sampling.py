"""Depth sampling along rays: linear coarse depths, their stratified jitter
(training), and inverse-CDF importance samples at deterministic quantiles
(inference) or at given random ones (training).

Counterpart of `nerf_workspaces_explorer_tpu/rays/sampling.py` (reference
nerf/rays/rays.py:74-121 and nerf/inference/nerf_replica_inference_handler.py:
216-243). The JAX package inverts the CDF with masked reductions because
gathers are slow on a TPU; here `torch.searchsorted` and `gather` do it.
"""

from __future__ import annotations

import torch


def linspace01(n: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """float32 linspace(0, 1, n) as `jnp.linspace` rounds it: i * f32(1/(n-1))
    (`torch.linspace` differs from it in the last bit at a few points)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    return torch.arange(n, dtype=torch.float32, device=device) * (1.0 / (n - 1))


def coarse_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int) -> torch.Tensor:
    """z = near * (1 - t) + far * t for t in linspace(0, 1, n_samples).

    near, far: [..., 1] -> [..., n_samples].
    """
    t = linspace01(n_samples, near.device)
    return near * (1.0 - t) + far * t


def stratified_perturb(z_vals: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """One draw per bin between interval midpoints (clamped by the first and
    last sample), t_rand ~ U[0, 1) of z_vals' shape (reference
    …training_handler.py:553-562; JAX `stratified_perturb`)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    return lower + (upper - lower) * t_rand


def sample_pdf(
    bins: torch.Tensor, weights: torch.Tensor, n_samples: int, u: torch.Tensor | None = None
) -> torch.Tensor:
    """Inverse-CDF sampling (reference rays.py:74-121).

    bins: [..., B] sorted bin edges (coarse z midpoints); weights: [..., B-1]
    unnormalized bin weights (coarse weights[1:-1]). Returns [..., n_samples]
    depths at the quantiles u: linspace(0, 1, n_samples) (ascending), or the
    given random u [..., n_samples] of training. The interval search reads a
    detached CDF (reference rays.py:103); callers detach the result.
    """
    weights = weights + 1e-5  # nan/zero-division guard (reference rays.py:87)
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = linspace01(n_samples, cdf.device).expand(*cdf.shape[:-1], n_samples)
    u = u.contiguous()
    # `right=True` counts the entries with cdf_b <= u, so `below` is the last
    # of them and `above` the first entry past u, clamped to the last bin
    # when u >= cdf[-1] (reference rays.py:103-111).
    above = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_below, bins_above = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_sorted_z(z_vals: torch.Tensor, z_samples: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse and importance depths (reference
    …inference_handler.py:243)."""
    return torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
