"""Plain float32 NeRF rendering: the yardstick the benchmark's frames are
judged against.

Written from the published description (Mildenhall et al., NeRF,
arXiv:2003.08934, sec. 4-5 and App. A; the proposal sampling of mip-NeRF 360,
arXiv:2111.12077, sec. 3) and the reference application's conventions
(OpenCV pinhole rays, positional encoding with the position divided by 10,
64 linear coarse depths, inverse-CDF importance samples at deterministic
quantiles, `floor(255 * clip(rgb, 0, 1))`). It imports nothing of the
program: weights come straight from the checkpoint's `.npz` arrays, and
every pose, ray, depth and weight is worked out here again.

Matrix products run in float32 with TF32 off (`fp32_matmuls`), rays in
blocks so that a frame fits beside nothing else on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

RAY_BLOCK = 4096


class Net(NamedTuple):
    """One MLP: trunk layers (w [in, out], b), the skip layer indices after
    which the encoded input is concatenated, and the heads."""

    trunk: List[tuple]
    skips: tuple
    alpha: tuple
    feature: tuple
    views: List[tuple]
    rgb: tuple
    pts_freqs: int
    view_freqs: int


def load_nets(path: str, device, skips_by_net: Dict[str, tuple], freqs_by_net: Dict[str, tuple]) -> Dict[str, Net]:
    """The `params||<net>||...` arrays of a checkpoint `.npz` as float32
    tensors on `device`, one `Net` per name in `skips_by_net`."""
    nets = {}
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k.startswith("params||")}
    for name, skips in skips_by_net.items():
        def leaf(*keys):
            return torch.as_tensor(arrays["||".join(("params", name, *keys))], dtype=torch.float32, device=device)

        def layer(*keys):
            return leaf(*keys, "w"), leaf(*keys, "b")

        depth = len({k.split("||")[3] for k in arrays if k.startswith(f"params||{name}||pts||")})
        n_views = len({k.split("||")[3] for k in arrays if k.startswith(f"params||{name}||views||")})
        pts_freqs, view_freqs = freqs_by_net[name]
        nets[name] = Net(
            trunk=[layer("pts", str(i)) for i in range(depth)],
            skips=tuple(skips),
            alpha=layer("alpha"),
            feature=layer("feature"),
            views=[layer("views", str(i)) for i in range(n_views)],
            rgb=layer("rgb"),
            pts_freqs=pts_freqs,
            view_freqs=view_freqs,
        )
    return nets


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


def encode(x: torch.Tensor, num_freqs: int, scale: float) -> torch.Tensor:
    """[..., 3] -> [..., 3 (1 + 2F)]: x / scale, then sin and cos of
    2^k x / scale for k < F, interleaved per frequency."""
    x = x / scale
    out = [x]
    for k in range(num_freqs):
        out += [torch.sin(x * 2.0**k), torch.cos(x * 2.0**k)]
    return torch.cat(out, -1)


def _dense(x: torch.Tensor, layer: tuple) -> torch.Tensor:
    return x @ layer[0] + layer[1]


def sigma_and_rgb(net: Net, pts: torch.Tensor, viewdirs: Optional[torch.Tensor]):
    """Raw density [..., S] and, given per-ray view directions [..., 3],
    colour [..., S, 3] after the sigmoid."""
    enc = encode(pts, net.pts_freqs, 10.0)
    h = enc
    for i, layer in enumerate(net.trunk):
        h = torch.relu(_dense(h, layer))
        if i in net.skips:
            h = torch.cat([enc, h], -1)
    sigma = _dense(h, net.alpha)[..., 0]
    if viewdirs is None:
        return sigma, None
    venc = encode(viewdirs, net.view_freqs, 1.0)[..., None, :].expand(*pts.shape[:-1], -1)
    h = torch.cat([_dense(h, net.feature), venc], -1)
    for layer in net.views:
        h = torch.relu(_dense(h, layer))
    return sigma, torch.sigmoid(_dense(h, net.rgb))


def composite(sigma: torch.Tensor, z: torch.Tensor, dir_norm: torch.Tensor):
    """Weights [R, S] and the transmittance before each sample [R, S]:
    alpha = 1 - exp(-relu(sigma) delta), delta the gap to the next depth
    (1e10 after the last) times |d|, T_i = prod_{j<i} (1 - alpha_j + 1e-10)."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dir_norm[:, None]
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    return alpha * trans, trans


def inverse_cdf(z_coarse: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """n depths at the quantiles linspace(0, 1, n) of the piecewise-constant
    pdf over the coarse midpoints, from the inner weights plus 1e-5 (the
    reference application's guards)."""
    bins = 0.5 * (z_coarse[:, 1:] + z_coarse[:, :-1])
    w = weights[:, 1:-1] + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = (torch.arange(n, dtype=torch.float32, device=z_coarse.device) * (1.0 / (n - 1))).expand(cdf.shape[0], n)
    above = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def rays(c2w: np.ndarray, height: int, width: int, hfov_degrees: float = 90.0, device="cpu"):
    """Origins, directions (camera z = 1) and unit view directions, [H W, 3]
    each, of a pinhole camera with principal point at the image centre."""
    fx = width / 2.0 / math.tan(math.radians(hfov_degrees / 2.0))
    i = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(height, width)
    j = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    cam = torch.stack([(i - (width - 1) / 2.0) / fx, (j - (height - 1) / 2.0) / fx, torch.ones_like(i)], -1)
    pose = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    dirs = (cam.reshape(-1, 1, 3) * pose[None, :3, :3]).sum(-1)
    origins = pose[:3, 3].expand_as(dirs)
    return origins, dirs, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


class Frame(NamedTuple):
    rgb8: torch.Tensor  # uint8 [H, W, 3]
    density_needed: int  # samples of the density pass before T < eps, summed over its rays
    fine_needed: int  # the same for the fine pass
    density_rays: int
    fine_rays: int


@torch.no_grad()
def render_frame(nets: Dict[str, Net], c2w: np.ndarray, spec: dict, device,
                 pixels: Optional[torch.Tensor] = None) -> Frame:
    """One frame of a hierarchical NeRF at float32.

    spec: height, width, near, far, n_samples, n_importance, merge (the fine
    net sees the sorted union of coarse and importance depths, or the
    importance depths alone), density_net ("coarse" or "proposal"),
    stride (the density pass and placement on every stride-th ray of each
    image axis, each stride x stride block taking its corner's depths),
    eps (the transmittance below which a sample is not needed).

    With `pixels` (flat indices into the H x W frame), only those pixels'
    rays take the fine pass (the density pass and placement of a strided
    frame still cover its lattice), and `rgb8` is [len(pixels), 3]."""
    h, w = spec["height"], spec["width"]
    stride = int(spec.get("stride", 1))
    origins, dirs, viewdirs = rays(c2w, h, w, device=device)
    dnorm = torch.linalg.norm(dirs, dim=-1)
    t = torch.arange(spec["n_samples"], dtype=torch.float32, device=device) * (1.0 / (spec["n_samples"] - 1))
    z_line = spec["near"] * (1.0 - t) + spec["far"] * t
    eps = spec["eps"]
    density = nets[spec["density_net"]]
    fine = nets["fine"]

    def place(o, d, dn):
        z = z_line.expand(o.shape[0], -1)
        sigma, _ = sigma_and_rgb(density, o[:, None, :] + d[:, None, :] * z[..., None], None)
        weights, trans = composite(sigma, z, dn)
        zs = inverse_cdf(z, weights, spec["n_importance"])
        zf = torch.sort(torch.cat([z, zs], -1), -1).values if spec["merge"] else zs
        return zf, int((trans > eps).sum())

    if stride > 1:
        lat = torch.arange(h * w, device=device).reshape(h, w)[::stride, ::stride].reshape(-1)
        zl, n_dens = [], 0
        for r0 in range(0, lat.numel(), RAY_BLOCK):
            idx = lat[r0 : r0 + RAY_BLOCK]
            zf, n = place(origins[idx], dirs[idx], dnorm[idx])
            zl.append(zf)
            n_dens += n
        zl = torch.cat(zl).reshape(h // stride, 1, w // stride, 1, -1)
        z_fine_all = zl.expand(-1, stride, -1, stride, -1).reshape(h * w, -1)
        density_rays = lat.numel()
    else:
        z_fine_all, n_dens, density_rays = None, 0, h * w

    sel = torch.arange(h * w, device=device) if pixels is None else pixels.to(device)
    n_sel = sel.numel()
    if pixels is not None:
        density_rays = n_sel if z_fine_all is None else density_rays
    rgb = torch.empty((n_sel, 3), dtype=torch.float32, device=device)
    n_fine = 0
    for r0 in range(0, n_sel, RAY_BLOCK):
        sl = slice(r0, min(r0 + RAY_BLOCK, n_sel))
        idx = sel[sl]
        o, d, dn = origins[idx], dirs[idx], dnorm[idx]
        if z_fine_all is None:
            zf, n = place(o, d, dn)
            n_dens += n
        else:
            zf = z_fine_all[idx]
        sigma, colour = sigma_and_rgb(fine, o[:, None, :] + d[:, None, :] * zf[..., None], viewdirs[idx])
        weights, trans = composite(sigma, zf, dn)
        rgb[sl] = (weights[..., None] * colour).sum(1)
        n_fine += int((trans > eps).sum())
    rgb8 = torch.floor(255.0 * torch.clamp(rgb, 0.0, 1.0)).to(torch.uint8)
    return Frame(rgb8 if pixels is not None else rgb8.reshape(h, w, 3), n_dens, n_fine, density_rays, n_sel)
