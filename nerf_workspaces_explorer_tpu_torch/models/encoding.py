"""Sinusoidal positional encoding.

Counterpart of `nerf_workspaces_explorer_tpu/models/encoding.py` (reference
nerf/models/embedding.py:6-48): x -> [x, sin(2^0 x), cos(2^0 x), ...,
sin(2^(F-1) x), cos(2^(F-1) x)] with the input pre-divided by
`scalar_factor`. 3D locations use F=10, factor=10 (-> 63 dims); view
directions use F=4, factor=1 (-> 27 dims). The interleaved per-frequency
[sin_f, cos_f] order is the reference's, so checkpoints load unchanged.
"""

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# mip-NeRF 360's integrated encoding (Barron et al., arXiv:2111.12077;
# google-research/multinerf internal/render.py, coord.py, geopoly.py): each
# sample interval is a conical frustum turned into a Gaussian, the Gaussian
# goes through the contraction of unbounded space (the covariance through
# its Jacobian at the mean), is projected onto a basis of directions and
# encoded by the expected sines of its projections.

F32_EPS = float(np.finfo(np.float32).eps)


def frustum_moments(t0: torch.Tensor, t1: torch.Tensor):
    """The distance moments of the conical frustum between t0 and t1 (mip-NeRF
    eqs. 7-8, multinerf's stable form): (mean distance, distance variance,
    radial variance per unit radius squared)."""
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    denom = torch.clamp(3 * mu**2 + hw**2, min=F32_EPS)
    t_mean = mu + (2 * mu * hw**2) / denom
    t_var = hw**2 / 3 - (4 / 15) * hw**4 * (12 * mu**2 - hw**2) / denom**2
    r_var = mu**2 / 4 + (5 / 12) * hw**2 - (4 / 15) * hw**4 / denom
    return t_mean, t_var, r_var


def cast_frustums(origins: torch.Tensor, dirs: torch.Tensor, radii: torch.Tensor, tdist: torch.Tensor):
    """Rays [R, 3] (directions not normalised), radii [R] and interval edges
    [R, N + 1] -> the intervals' Gaussians: means [R, N, 3], covariances
    [R, N, 3, 3] = t_var d d^T + r^2 r_var (I - d d^T / |d|^2)."""
    t_mean, t_var, r_var = frustum_moments(tdist[:, :-1], tdist[:, 1:])
    d = dirs[:, None, :]
    means = origins[:, None, :] + t_mean[..., None] * d
    d_outer = d[..., :, None] * d[..., None, :]
    d_mag_sq = torch.clamp((dirs**2).sum(-1), min=1e-10)[:, None, None, None]
    null_outer = torch.eye(3, dtype=dirs.dtype, device=dirs.device) - d_outer / d_mag_sq
    covs = t_var[..., None, None] * d_outer + (radii[:, None] ** 2 * r_var)[..., None, None] * null_outer
    return means, covs


def contract(x: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 eq. 10: x inside the unit ball, else (2 - 1/|x|) x/|x|."""
    mag_sq = torch.clamp((x**2).sum(-1, keepdim=True), min=F32_EPS)
    return torch.where(mag_sq <= 1, x, ((2 * torch.sqrt(mag_sq) - 1) / mag_sq) * x)


def contract_gaussian(means: torch.Tensor, covs: torch.Tensor):
    """Gaussians through `contract`, linearised at the mean: (contract(mean),
    J cov J^T), J = s I + (2 (1 - n) / n^4) x x^T outside the unit ball
    (s = (2n - 1) / n^2, n = |x|), the identity inside."""
    mag_sq = torch.clamp((means**2).sum(-1, keepdim=True), min=F32_EPS)
    n = torch.sqrt(mag_sq)
    outside = (mag_sq > 1)[..., None]
    s = (2 * n - 1) / mag_sq
    eye = torch.eye(3, dtype=means.dtype, device=means.device)
    jac = s[..., None] * eye + (2 * (1 - n) / mag_sq**2)[..., None] * means[..., :, None] * means[..., None, :]
    jac = torch.where(outside, jac, eye.expand_as(jac))
    return contract(means), jac @ covs @ jac.transpose(-1, -2)


def _sq_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances between the columns of a [3, n] and b [3, m]."""
    return np.maximum(0.0, (a**2).sum(0)[:, None] + (b**2).sum(0)[None, :] - 2 * a.T @ b)


def icosahedron_basis(subdivisions: int = 2, eps: float = 1e-4) -> np.ndarray:
    """float64 [n, 3]: the vertices of the icosahedron tessellated `subdivisions`
    times on the unit sphere, with antipodes removed (multinerf
    geopoly.generate_basis('icosahedron', 2): 21 directions), xyz reversed
    as there."""
    a = (np.sqrt(5.0) + 1) / 2
    verts = np.array([(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a), (0, a, 1), (0, a, -1), (0, -a, 1),
                      (0, -a, -1), (a, 1, 0), (-a, 1, 0), (a, -1, 0), (-a, -1, 0)]) / np.sqrt(a + 2)
    faces = np.array([(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1), (8, 10, 1), (8, 3, 10), (5, 3, 8),
                      (5, 2, 3), (2, 7, 3), (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
                      (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11)])
    v = subdivisions
    weights = np.array([(i, j, v - (i + j)) for i in range(v + 1) for j in range(v + 1 - i)], np.float64) / v
    tess = np.concatenate([weights @ verts[f] for f in faces])
    tess /= np.linalg.norm(tess, axis=-1, keepdims=True)
    sq = _sq_dist(tess.T, tess.T)
    tess = tess[np.unique([int(np.min(np.argwhere(d <= eps))) for d in sq])]
    match = _sq_dist(tess.T, -tess.T) < eps
    return tess[np.any(np.triu(match), axis=-1)][:, ::-1].copy()


def integrated_pos_enc(means: torch.Tensor, covs: torch.Tensor, basis: torch.Tensor, n_degrees: int) -> torch.Tensor:
    """Contracted Gaussians [..., 3], [..., 3, 3] and a basis [n, 3] -> the
    [..., 2 n_degrees n] expected sines: with m = B x and v = diag(B cov B^T),
    exp(-4^l v / 2) sin(2^l m) for l < n_degrees (degree-major), then the
    same with cosines."""
    m = means @ basis.T
    v = ((covs @ basis.T) * basis.T).sum(-2)
    scales = 2.0 ** torch.arange(n_degrees, dtype=means.dtype, device=means.device)
    sm = (m[..., None, :] * scales[:, None]).flatten(-2)
    damp = torch.exp(-0.5 * (v[..., None, :] * scales[:, None] ** 2).flatten(-2))
    return torch.cat([damp * torch.sin(sm), damp * torch.cos(sm)], -1)
