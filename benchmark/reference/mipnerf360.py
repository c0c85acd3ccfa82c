"""mip-NeRF 360 in plain float32 PyTorch: the yardstick its frame cells are
judged against.

Written from the published description (Barron et al., CVPR 2022,
arXiv:2111.12077, sec. 2-3) and multinerf's test-time forward pass
(internal/models.py `Model.__call__`, `MLP`; stepfun.py `max_dilate_weights`,
`sample_intervals`, `invert_cdf`; render.py `cast_rays`,
`conical_frustum_to_gaussian`, `compute_alpha_weights`; coord.py `contract`,
`track_linearize`, `lift_and_diagonalize`, `integrated_pos_enc`, `pos_enc`;
geopoly.py `generate_basis`), literally: the sort of the dilated edges, the
softmax of log-weights, `jnp.interp`'s search, the cosines as sin(x + pi/2),
the Jacobian by autograd. It imports nothing of the program: the weights
are drawn here from the seeded checkpoint's seed by the recipe it names
(`init_params`), and poses, rays and radii are worked out again
(`render_frame`). Products run in float32 with TF32 off (`fp32_matmuls`),
rays in blocks; `matmul(x, w)` computes each dense layer's product (the
control passes `reference.train.fp8_matmul`).

`spec` is the checkpoint's `spec` dictionary.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


@contextlib.contextmanager
def fp32_matmuls():
    """float32 products with TF32 off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _sq_dist(a, b):
    return np.maximum(0.0, (a**2).sum(0)[:, None] + (b**2).sum(0)[None, :] - 2 * a.T @ b)


def generate_basis(subdivisions: int = 2, eps: float = 1e-4) -> np.ndarray:
    """geopoly.generate_basis('icosahedron', subdivisions): [n, 3]."""
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
    tess = tess[np.unique([int(np.min(np.argwhere(d <= eps))) for d in _sq_dist(tess.T, tess.T)])]
    keep = np.any(np.triu(_sq_dist(tess.T, -tess.T) < eps), axis=-1)
    return tess[keep][:, ::-1].copy()


def layer_shapes(spec: dict) -> Dict[str, list]:
    n_basis = len(generate_basis(spec["basis_subdivisions"]))
    e = 2 * spec["n_degrees"] * n_basis
    w, p = spec["nerf_width"], spec["prop_width"]
    prop = [(f"trunk{i}", e if i == 0 else p, p) for i in range(spec["prop_depth"])] + [("density", p, 1)]
    nerf = [(f"trunk{i}", e if i == 0 else w + (e if i == spec["skip"] + 1 else 0), w)
            for i in range(spec["nerf_depth"])]
    nerf += [("density", w, 1), ("bottleneck", w, spec["bottleneck"]),
             ("view", spec["bottleneck"] + 3 + 6 * spec["view_degrees"], spec["view_width"]),
             ("rgb", spec["view_width"], 3)]
    return {"prop": prop, "nerf": nerf}


def init_params(seed: int, spec: dict, device="cpu") -> Dict[str, Dict[str, tuple]]:
    """{net: {layer name: (w [in, out], b)}}: w ~ U(+-sqrt(6 / fan_in)) from
    default_rng(SeedSequence([seed, net, layer])), net 0 the proposal MLP and
    1 the NeRF MLP, b = 0."""
    out = {}
    for net_id, net in enumerate(("prop", "nerf")):
        out[net] = {}
        for layer_id, (name, fan_in, fan_out) in enumerate(layer_shapes(spec)[net]):
            rng = np.random.default_rng(np.random.SeedSequence([int(seed), net_id, layer_id]))
            lim = np.sqrt(6.0 / fan_in)
            w = rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)
            out[net][name] = (torch.as_tensor(w, device=device), torch.zeros(fan_out, device=device))
    return out


# ---------------------------------------------------------------------------
# Step functions (stepfun.py).

def max_dilate_weights(t, w, dilation: float, domain=(0.0, 1.0)):
    eps2 = EPS**2
    p = w / torch.clamp(t[..., 1:] - t[..., :-1], min=eps2)
    t0, t1 = t[..., :-1] - dilation, t[..., 1:] + dilation
    t_d = torch.sort(torch.cat([t, t0, t1], -1), -1).values.clamp(*domain)
    inside = (t0[..., None, :] <= t_d[..., None]) & (t1[..., None, :] > t_d[..., None])
    p_d = torch.where(inside, p[..., None, :], torch.zeros_like(p[..., None, :])).amax(-1)[..., :-1]
    w_d = p_d * (t_d[..., 1:] - t_d[..., :-1])
    w_d = w_d / torch.clamp(w_d.sum(-1, keepdim=True), min=eps2)
    return t_d, w_d


def _interp(x, xp, fp):
    """jnp.interp, row by row: the bracket is [xp[i-1], xp[i]) with i the
    first index whose xp exceeds x."""
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, xp.shape[-1] - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    small = dx.abs() <= np.spacing(np.float32(EPS))
    return torch.where(small, f0, f0 + (x - x0) / torch.where(small, torch.ones_like(dx), dx) * (f1 - f0))


def sample_intervals(t, w_logits, n: int, domain=(0.0, 1.0)):
    w = torch.softmax(w_logits, -1)
    cw = torch.clamp(torch.cumsum(w[..., :-1], -1), max=1.0)
    edge = torch.ones_like(w[..., :1])
    cw = torch.cat([torch.zeros_like(edge), cw, edge], -1)
    pad = 1.0 / (2 * n)
    u = torch.linspace(pad, 1.0 - pad - EPS, n, device=t.device).expand(*t.shape[:-1], n)
    centers = _interp(u, cw, t)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], -1)


# ---------------------------------------------------------------------------
# Gaussians and their encoding (render.py, coord.py).

def cast_rays(tdist, origins, dirs, radii):
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    denom = torch.clamp(3 * mu**2 + hw**2, min=EPS)
    t_mean = mu + (2 * mu * hw**2) / denom
    t_var = hw**2 / 3 - (4 / 15) * hw**4 * (12 * mu**2 - hw**2) / denom**2
    r_var = (mu**2 / 4 + (5 / 12) * hw**2 - (4 / 15) * hw**4 / denom) * radii[..., None] ** 2
    d = dirs[..., None, :]
    mean = d * t_mean[..., None] + origins[..., None, :]
    d_mag_sq = torch.clamp((dirs**2).sum(-1), min=1e-10)[..., None, None, None]
    d_outer = d[..., :, None] * d[..., None, :]
    null_outer = torch.eye(3, device=dirs.device) - d_outer / d_mag_sq
    cov = t_var[..., None, None] * d_outer + r_var[..., None, None] * null_outer
    return mean, cov


def contract(x):
    mag_sq = torch.clamp((x**2).sum(-1, keepdim=True), min=EPS)
    return torch.where(mag_sq <= 1, x, ((2 * torch.sqrt(mag_sq) - 1) / mag_sq) * x)


def track_linearize(mean, cov):
    """contract(mean) and J cov J^T, J the Jacobian of `contract` at the mean."""
    flat = mean.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacrev(contract))(flat).reshape(*mean.shape, 3)
    return contract(mean), jac @ cov @ jac.transpose(-1, -2)


def integrated_pos_enc(mean, cov, basis_t, n_degrees: int):
    lifted_mean = mean @ basis_t
    lifted_var = (basis_t * (cov @ basis_t)).sum(-2)
    scales = 2.0 ** torch.arange(n_degrees, device=mean.device, dtype=mean.dtype)
    shape = lifted_mean.shape[:-1] + (-1,)
    sm = (lifted_mean[..., None, :] * scales[:, None]).reshape(shape)
    sv = (lifted_var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    x = torch.cat([sm, sm + 0.5 * math.pi], -1)
    return torch.exp(-0.5 * torch.cat([sv, sv], -1)) * torch.sin(x)


def pos_enc(x, degrees: int):
    scales = 2.0 ** torch.arange(degrees, device=x.device, dtype=x.dtype)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))], -1)


# ---------------------------------------------------------------------------
# The MLPs and the frame.

def _f32_matmul(x, w):
    return x @ w


def _dense(x, layer, matmul):
    return matmul(x, layer[0]) + layer[1]


def prop_density(net, x, matmul):
    h = x
    for i in range(sum(1 for k in net if k.startswith("trunk"))):
        h = torch.relu(_dense(h, net[f"trunk{i}"], matmul))
    return torch.nn.functional.softplus(_dense(h, net["density"], matmul)[..., 0] - 1.0)


def nerf_density_rgb(net, x, view_enc, spec: dict, matmul):
    h = x
    for i in range(spec["nerf_depth"]):
        h = torch.relu(_dense(h, net[f"trunk{i}"], matmul))
        if i == spec["skip"]:
            h = torch.cat([h, x], -1)
    density = torch.nn.functional.softplus(_dense(h, net["density"], matmul)[..., 0] - 1.0)
    b = _dense(h, net["bottleneck"], matmul)
    v = torch.cat([b, view_enc[..., None, :].expand(*b.shape[:-1], view_enc.shape[-1])], -1)
    v = torch.relu(_dense(v, net["view"], matmul))
    rgb = torch.sigmoid(_dense(v, net["rgb"], matmul)) * (1 + 2 * 0.001) - 0.001
    return density, rgb


def alpha_weights(density, tdist, dirs):
    """Weights of the intervals; the last interval's length is 1e10 (opaque)."""
    t_delta = tdist[..., 1:] - tdist[..., :-1]
    t_delta = torch.cat([t_delta[..., :-1], torch.full_like(t_delta[..., -1:], 1e10)], -1)
    dd = density * t_delta * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], -1)], -1))
    return alpha * trans


@torch.no_grad()
def render_rays(params, origins, dirs, viewdirs, radii, spec: dict,
                matmul: Optional[Callable] = None) -> torch.Tensor:
    """float32 [R, 3]: the colour of each ray (module note)."""
    matmul = matmul or _f32_matmul
    device = origins.device
    basis_t = torch.as_tensor(generate_basis(spec["basis_subdivisions"]).T, dtype=torch.float32, device=device)
    t_n, t_f = spec["near"], spec["far"]

    def s_to_t(s):
        return 1.0 / (s * (1.0 / t_f) + (1 - s) * (1.0 / t_n))

    r = origins.shape[0]
    sdist = torch.cat([torch.zeros(r, 1, device=device), torch.ones(r, 1, device=device)], -1)
    weights = torch.ones(r, 1, device=device)
    samples = list(spec["prop_samples"]) + [spec["nerf_samples"]]
    prod = 1
    rgb = None
    with fp32_matmuls():
        for level, n in enumerate(samples):
            dilation = spec["dilation_bias"] + spec["dilation_multiplier"] / prod
            prod *= n
            if level > 0:
                sdist, weights = max_dilate_weights(sdist, weights, dilation)
                sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
            logits = torch.where(sdist[..., 1:] > sdist[..., :-1], torch.log(weights),
                                 torch.full_like(weights, -math.inf))
            sdist = sample_intervals(sdist, logits, n)
            tdist = s_to_t(sdist)
            mean, cov = cast_rays(tdist, origins, dirs, radii)
            mean, cov = track_linearize(mean, cov)
            x = integrated_pos_enc(mean, cov, basis_t, spec["n_degrees"])
            if level < len(samples) - 1:
                density = prop_density(params["prop"], x, matmul)
            else:
                density, rgb = nerf_density_rgb(params["nerf"], x, pos_enc(viewdirs, spec["view_degrees"]), spec,
                                                 matmul)
            weights = alpha_weights(density, tdist, dirs)
    return (weights[..., None] * rgb).sum(-2)


# ---------------------------------------------------------------------------
# Frames.

RAY_BLOCK = 1200


def load(path: str, device) -> tuple:
    """A seeded checkpoint's (params, spec)."""
    import json

    with open(path) as f:
        meta = json.load(f)
    spec = dict(meta["spec"])
    return init_params(int(meta["seed"]), spec, device), spec


@torch.no_grad()
def render_frame(params, spec: dict, c2w, height: int, width: int, device, pixels=None,
                 matmul: Optional[Callable] = None) -> torch.Tensor:
    """uint8 [len(pixels), 3] (or [H, W, 3]) of a pose: the frame's pinhole
    rays (`reference.nerf.rays`: 90 degrees across, z = 1), each pixel's
    radius the distance to its right neighbour's direction (the last
    column's to its left one's) x 2 / sqrt(12), all divided by the spec's
    scene scale; floor(255 clip(rgb, 0, 1))."""
    from reference import nerf

    origins, dirs, viewdirs = nerf.rays(c2w, height, width, device=device)
    grid = dirs.reshape(height, width, 3)
    dx = torch.linalg.norm(grid[:, 1:] - grid[:, :-1], dim=-1)
    radii = (torch.cat([dx, dx[:, -1:]], -1) * (2 / np.sqrt(12))).reshape(-1)
    sel = torch.arange(height * width, device=device) if pixels is None else torch.as_tensor(pixels).to(device)
    scale = np.float32(spec["scene_scale"])
    out = []
    for r0 in range(0, sel.numel(), RAY_BLOCK):
        idx = sel[r0 : r0 + RAY_BLOCK]
        out.append(render_rays(params, origins[idx] / scale, dirs[idx] / scale, viewdirs[idx], radii[idx] / scale,
                               spec, matmul))
    rgb8 = torch.floor(255.0 * torch.clamp(torch.cat(out), 0.0, 1.0)).to(torch.uint8)
    return rgb8 if pixels is not None else rgb8.reshape(height, width, 3)
