"""mip-NeRF 360's frame: placement, integrated encoding, the two MLPs and
compositing, through the kernels of `csrc/mipnerf360.cu` on the card and
their plain versions on the CPU.

The model (`models/mipnerf360.py`) is multinerf's test-time forward pass.
A frame takes three levels: the proposal MLP over 64 intervals a ray, twice,
then the NeRF MLP over 32. Before each level `place` draws the level's
intervals from the weights of the one before (the first from one interval
of weight 1), max-dilated before levels 1 and 2 by 0.0025 + 0.5 / P (P =
64, then 64 x 64). `encode` turns each interval into its contracted
Gaussian's 504 expected sines; the MLP gives densities (and at the last
level colours); `composite` gives the weights the next level places by,
and the colour. Every sample is evaluated: the last interval is opaque.

Products take bf16 operands and sum in fp32 (the explorer's serving
precision); each layer's output is rounded to bf16 where the next reads it;
the density and rgb heads are fp32 dot products of that bf16 row with bf16
weights. Placement, encoding and compositing are fp32.

On the card (`csrc/mipnerf360.cu`, one library): K10 `m360_encode_launch`,
K11 `m360_linear_launch` (one dense layer of the NeRF MLP, its epilogue
taking the density or rgb head; or the proposal MLP whole),
K12 `m360_place_launch`, K13 `m360_composite_launch`. Rays are
taken in chunks of `CHUNK_ROWS` samples through the encoding and the MLPs,
whose bf16 matrices lie in 64 x 64 swizzled slabs (the source's note;
`to_slabs`). The plain versions (`*_plain`) compute the same arithmetic on
row-major tensors; they differ from the kernels in summation order and in
the kernels' polynomial sine and cosine. A frame adds its samples to the
program counters `render.m360_prop_samples` and `render.m360_nerf_samples`
while tracing, in the spans `m360.placement`, `m360.proposal` (one a round)
and `m360.nerf` (each holding its chunks' `m360.encode`) and
`m360.composite`.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.models import encoding
from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import Mip360Spec, basis, params_to_torch, view_encoding
from nerf_workspaces_explorer_tpu_torch.obs import profiler
from nerf_workspaces_explorer_tpu_torch.obs.profiler import span
from nerf_workspaces_explorer_tpu_torch.ops import _build

LIBRARY = "mipnerf360"
# Kernel launches made by the wrappers, by kernel.
LAUNCHES = {"encode": 0, "linear": 0, "place": 0, "composite": 0}
# Sample rows a chunk of the encoding and the MLPs takes on the card.
CHUNK_ROWS = 65536
# K11's epilogues (csrc/mipnerf360.cu); "prop" is the proposal MLP whole.
EPI = {"hidden": 0, "hidden_density": 1, "linear": 3, "rgb": 4, "prop": 5}
TILE = 64  # a slab's rows and bf16 columns
ENC_PAD = 512  # the encoding's 504 columns, padded to whole slabs
RAY_MULTIPLE = 4  # rays padded to a multiple: 32 samples a ray x 4 = one 128-row tile


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Slab layout (csrc/mipnerf360.cu's note).

def _swizzle_index(device) -> torch.Tensor:
    """[64 rows, 8 chunks]: the 16-byte chunk of a row that lands at each
    position under the 128-byte swizzle."""
    r = torch.arange(TILE, device=device)[:, None]
    p = torch.arange(8, device=device)[None, :]
    return p ^ (r & 7)


def to_slabs(x: torch.Tensor) -> torch.Tensor:
    """[M, K] -> bf16 [M / 64, K / 64, 64, 64] slabs (M, K multiples of 64)."""
    m, k = x.shape
    t = x.to(torch.bfloat16).reshape(m // TILE, TILE, k // TILE, 8, 8).permute(0, 2, 1, 3, 4)
    idx = _swizzle_index(x.device)[None, None, :, :, None].expand(*t.shape)
    return t.gather(3, idx).reshape(m // TILE, k // TILE, TILE, TILE).contiguous()


def from_slabs(s: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Inverse of `to_slabs`: [rows, cols] bf16 (the slabs' flat bytes viewed
    as bf16, K = cols rounded up to 64)."""
    kt = -(-cols // TILE)
    t = s.reshape(-1).view(torch.bfloat16)[: rows * kt * TILE].reshape(rows // TILE, kt, TILE, 8, 8)
    idx = _swizzle_index(s.device)[None, None, :, :, None].expand(*t.shape)
    out = torch.empty_like(t).scatter_(3, idx, t)
    return out.permute(0, 2, 1, 3, 4).reshape(rows, kt * TILE)[:, :cols]


def pack_linear(w: torch.Tensor, bn: int) -> torch.Tensor:
    """A layer's weights [K, N] (K a multiple of 64, N of bn) -> bf16
    [N / bn, K / 64, bn, 64]: for each block of bn columns, K / 64 slabs of
    its transpose, each row swizzled."""
    k, n = w.shape
    wt = w.T.to(torch.bfloat16).reshape(n // bn, bn, k // TILE, 8, 8).permute(0, 2, 1, 3, 4)
    r = torch.arange(bn, device=w.device)[:, None]
    idx = (torch.arange(8, device=w.device)[None, :] ^ (r & 7))[None, None, :, :, None].expand(*wt.shape)
    return wt.gather(3, idx).reshape(n // bn, k // TILE, bn, TILE).contiguous()


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([w, w.new_zeros(rows - w.shape[0], w.shape[1])]) if rows > w.shape[0] else w


# ---------------------------------------------------------------------------
# The model's parameters as the path reads them.

class Mip360Model:
    """A tree (`models.mipnerf360.init_params`'s layout) on `device`: fp32
    leaves for the plain path, and on the card each layer's packed bf16
    weights (the encoding's rows padded to 512, the skip layer's [h, x]
    rows laid as its two sources), the heads' bf16 weight vectors and the
    view layer split into its bottleneck rows (a product) and its view rows
    (a bias per ray)."""

    def __init__(self, tree: Dict[str, Any], spec: Mip360Spec, device) -> None:
        self.spec = spec
        self.device = torch.device(device)
        self.params = params_to_torch(tree, self.device)
        self.basis = torch.as_tensor(basis(spec.basis_subdivisions), dtype=torch.float32, device=self.device)
        p, n = self.params["prop"], self.params["nerf"]
        self.b_sigma = {"prop": float(p["density"]["b"][0]), "nerf": float(n["density"]["b"][0])}
        self.packed: Optional[Dict[str, Any]] = None
        if self.device.type == "cuda":
            self.packed = self._pack()

    def _pack(self) -> Dict[str, Any]:
        s, e = self.spec, self.spec.enc_dim
        if s.prop_width % 256 or s.nerf_width % 256 or s.bottleneck % 256 or s.view_width != 128 or e > ENC_PAD:
            raise ValueError(f"the card's mip-NeRF 360 kernels take widths of multiples of 256, a view layer of "
                             f"128 and at most {ENC_PAD} encoded features, got {s}")

        def layer(w, b, first_rows=None):
            if first_rows is not None:  # [h, x]: h's rows, then x's padded
                w = torch.cat([w[:first_rows], _pad_rows(w[first_rows:], ENC_PAD)])
            elif w.shape[0] == e:
                w = _pad_rows(w, ENC_PAD)
            return pack_linear(w, 256), b.contiguous()

        p, n = self.params["prop"], self.params["nerf"]
        prop = [layer(l["w"], l["b"]) for l in p["trunk"]]  # one launch: the slabs and biases layer after layer
        nerf = [layer(l["w"], l["b"], s.nerf_width if i == s.skip + 1 else None) for i, l in enumerate(n["trunk"])]
        view_w = n["view"]["w"]
        return {
            "prop": torch.cat([w for w, _ in prop], 1), "prop_b": torch.cat([b for _, b in prop]),
            "prop_wd": _bf(p["density"]["w"][:, 0]).contiguous(),
            "nerf": nerf, "nerf_wd": _bf(n["density"]["w"][:, 0]).contiguous(),
            "bottleneck": layer(n["bottleneck"]["w"], n["bottleneck"]["b"]),
            "view": pack_linear(view_w[: s.bottleneck], 128),
            "rgb_w": _bf(n["rgb"]["w"]).contiguous(), "rgb_b": n["rgb"]["b"].contiguous(),
        }


# ---------------------------------------------------------------------------
# Placement.

def s_to_t(s: torch.Tensor, spec: Mip360Spec) -> torch.Tensor:
    """Normalised distance -> metric: s spaced linearly in disparity between
    the spec's near and far."""
    return 1.0 / (s * np.float32(1.0 / spec.far) + (1 - s) * np.float32(1.0 / spec.near))


def max_dilate(t: torch.Tensor, w: torch.Tensor, dilation: float):
    """A step function's edges [R, m + 1] and weights [R, m] -> the max-dilated
    one's, edges [R, 3m - 1] and weights [R, 3m - 2]: on the sorted union of
    the edges and the edges widened by +-dilation, clipped to [0, 1], each
    interval takes the largest density w / width whose widened span holds its
    left edge; back to weights, renormalised, the outer edge at each end
    dropped (multinerf stepfun.max_dilate_weights, then [1:-1])."""
    eps2 = encoding.F32_EPS**2
    p = w / torch.clamp(t[:, 1:] - t[:, :-1], min=eps2)
    t0, t1 = t[:, :-1] - np.float32(dilation), t[:, 1:] + np.float32(dilation)
    td = torch.sort(torch.cat([t, t0, t1], -1), -1).values.clamp(0.0, 1.0)
    inside = (t0[:, None, :] <= td[:, :-1, None]) & (t1[:, None, :] > td[:, :-1, None])
    pd = torch.where(inside, p[:, None, :], torch.zeros_like(p[:, None, :])).amax(-1)
    wd = pd * (td[:, 1:] - td[:, :-1])
    wd = wd / torch.clamp(wd.sum(-1, keepdim=True), min=eps2)
    return td[:, 1:-1], wd[:, 1:-1]


def place_plain(t_in: torch.Tensor, w_in: torch.Tensor, dilation: Optional[float], n: int, spec: Mip360Spec):
    """Edges [R, m + 1] and weights [R, m] of a step function -> the next
    level's n intervals, (normalised edges, metric edges) [R, n + 1] each:
    max-dilated by `dilation` (None: not), then the centres at u =
    linspace(1/2n, 1 - 1/2n - eps, n) of the inverse of the piecewise-linear
    CDF of the weights (empty intervals dropped), the edges their midpoints,
    the outer two reflected about the outer centres and clipped to [0, 1]."""
    t, w = (t_in, w_in) if dilation is None else max_dilate(t_in, w_in, dilation)
    w = torch.where(t[:, 1:] > t[:, :-1], w, torch.zeros_like(w))
    w = w / w.sum(-1, keepdim=True)
    cw = torch.clamp(torch.cumsum(w[:, :-1], -1), max=1.0)
    edge = torch.ones_like(w[:, :1])
    cw = torch.cat([0 * edge, cw, edge], -1)
    pad = 1.0 / (2 * n)
    u = torch.linspace(pad, 1.0 - pad - encoding.F32_EPS, n, device=t.device).expand(t.shape[0], n).contiguous()
    i = torch.searchsorted(cw.contiguous(), u, right=True).clamp(1, cw.shape[1] - 1)
    x0, x1 = cw.gather(1, i - 1), cw.gather(1, i)
    f0, f1 = t.gather(1, i - 1), t.gather(1, i)
    dx = x1 - x0
    small = dx <= 1.4e-14
    centers = torch.where(small, f0, f0 + (u - x0) / torch.where(small, torch.ones_like(dx), dx) * (f1 - f0))
    mid = (centers[:, 1:] + centers[:, :-1]) / 2
    first = torch.clamp(2 * centers[:, :1] - mid[:, :1], min=0.0)
    last = torch.clamp(2 * centers[:, -1:] - mid[:, -1:], max=1.0)
    s = torch.cat([first, mid, last], -1)
    return s, s_to_t(s, spec)


def place(t_in, w_in, dilation: Optional[float], n: int, spec: Mip360Spec):
    """`place_plain`, on the card K12."""
    if t_in.device.type != "cuda":
        return place_plain(t_in, w_in, dilation, n, spec)
    r, m = w_in.shape
    s_out = torch.empty((r, n + 1), dtype=torch.float32, device=t_in.device)
    t_out = torch.empty_like(s_out)
    _build.launch(LIBRARY, "m360_place_launch", t_in.contiguous().data_ptr(), w_in.contiguous().data_ptr(), m,
                  -1.0 if dilation is None else float(dilation), s_out.data_ptr(), t_out.data_ptr(), n, r,
                  float(np.float32(1.0 / spec.near)), float(np.float32(1.0 / spec.far)),
                  _build.stream_handle(t_in.device))
    LAUNCHES["place"] += 1
    return s_out, t_out


# ---------------------------------------------------------------------------
# Encoding.

def encode_plain(o, d, radii, tdist, model: Mip360Model) -> torch.Tensor:
    """Rays (scaled) and interval edges [R, S + 1] -> [R S, 504] bf16 values
    (as float32): `models.encoding`'s Gaussians, contraction and expected
    sines."""
    means, covs = encoding.cast_frustums(o, d, radii, tdist)
    means, covs = encoding.contract_gaussian(means, covs)
    x = encoding.integrated_pos_enc(means, covs, model.basis, model.spec.n_degrees)
    return _bf(x.reshape(-1, x.shape[-1]))


def encode_slabs(o, d, radii, tdist, model: Mip360Model) -> torch.Tensor:
    """K10: `encode_plain`'s features in slabs, [R S / 64, 8, 64, 64] bf16."""
    r, s = tdist.shape[0], tdist.shape[1] - 1
    out = torch.empty((r * s // TILE, ENC_PAD // TILE, TILE, TILE), dtype=torch.bfloat16, device=o.device)
    _build.launch(LIBRARY, "m360_encode_launch", o.data_ptr(), d.data_ptr(), radii.data_ptr(), tdist.data_ptr(),
                  model.basis.data_ptr(), out.data_ptr(), r, s, _build.stream_handle(o.device))
    LAUNCHES["encode"] += 1
    return out


# ---------------------------------------------------------------------------
# Dense layers on the card.

def linear_slabs(epi: str, a0, kt0: int, w_packed, bias, n: int, rows: int, *, a1=None, kt1: int = 0,
                 rows_per_bias: int = 0, out=None, dens=None, wd=None, rgb=None, wrgb=None, brgb=None) -> None:
    """K11: one dense layer over `rows` rows of slabs (module note); the
    outputs are the caller's."""
    null = ctypes.c_void_p(0)

    def ptr(t):
        return null if t is None else t.data_ptr()

    kt_out = n // TILE
    _build.launch(LIBRARY, "m360_linear_launch", EPI[epi], ptr(a0), kt0, ptr(a1), kt1, ptr(w_packed), ptr(bias),
                  rows_per_bias, ptr(out), kt_out, ptr(dens), ptr(wd), ptr(rgb), ptr(wrgb), ptr(brgb), rows, n,
                  _build.stream_handle(a0.device))
    LAUNCHES["linear"] += 1


def _act(rows: int, width: int, device) -> torch.Tensor:
    return torch.empty((rows // TILE, width // TILE, TILE, TILE), dtype=torch.bfloat16, device=device)


def prop_density_slabs(model: Mip360Model, enc, rows: int, dens_out) -> None:
    """The proposal MLP over a chunk's encoding slabs, one launch -> its raw
    densities [rows, 1] (before the bias)."""
    pk = model.packed
    linear_slabs("prop", enc, ENC_PAD // TILE, pk["prop"], pk["prop_b"], model.spec.prop_width, rows,
                 dens=dens_out, wd=pk["prop_wd"])


def nerf_slabs(model: Mip360Model, enc, rows: int, vray, samples: int, dens_out, rgb_out) -> None:
    """The NeRF MLP over a chunk's encoding slabs -> raw density sums by
    256-column block [rows, width / 256] and colours [rows, 3]."""
    s, pk = model.spec, model.packed
    w, dev = s.nerf_width, enc.device
    h, kt = enc, ENC_PAD // TILE
    for i, (wp, b) in enumerate(pk["nerf"]):
        out = _act(rows, w, dev)
        skip = i == s.skip + 1
        last = i == len(pk["nerf"]) - 1
        linear_slabs("hidden_density" if last else "hidden", h, kt, wp, b, w, rows, out=out,
                     a1=enc if skip else None, kt1=ENC_PAD // TILE if skip else 0,
                     dens=dens_out if last else None, wd=pk["nerf_wd"] if last else None)
        h, kt = out, w // TILE
    bott = _act(rows, s.bottleneck, dev)
    wp, b = pk["bottleneck"]
    linear_slabs("linear", h, kt, wp, b, s.bottleneck, rows, out=bott)
    linear_slabs("rgb", bott, s.bottleneck // TILE, pk["view"], vray, s.view_width, rows, rows_per_bias=samples,
                 rgb=rgb_out, wrgb=pk["rgb_w"], brgb=pk["rgb_b"])


# ---------------------------------------------------------------------------
# Dense layers on the CPU.

def prop_density_plain(model: Mip360Model, x: torch.Tensor) -> torch.Tensor:
    """[rows, 504] bf16 values -> raw densities [rows, 1] before the bias."""
    p = model.params["prop"]
    h = x
    for layer in p["trunk"]:
        h = _bf(torch.relu(h @ _bf(layer["w"]) + layer["b"]))
    return h @ _bf(p["density"]["w"])


def nerf_plain(model: Mip360Model, x: torch.Tensor, vray: torch.Tensor, samples: int):
    """[rows, 504] bf16 values and per-ray view biases [R, 128] -> (raw
    densities [rows, 1] before the bias, colours [rows, 3])."""
    s, n = model.spec, model.params["nerf"]
    h = x
    for i, layer in enumerate(n["trunk"]):
        h = _bf(torch.relu(h @ _bf(layer["w"]) + layer["b"]))
        if i == s.skip:
            h = torch.cat([h, x], -1)
    dens = h @ _bf(n["density"]["w"])
    bott = _bf(h @ _bf(n["bottleneck"]["w"]) + n["bottleneck"]["b"])
    v = bott @ _bf(n["view"]["w"][: s.bottleneck]) + vray.repeat_interleave(samples, 0)
    v = _bf(torch.relu(v))
    rgb = torch.sigmoid(v @ _bf(n["rgb"]["w"]) + n["rgb"]["b"]) * 1.002 - 0.001
    return dens, rgb


# ---------------------------------------------------------------------------
# Compositing.

def composite_plain(tdist, raw, b_sigma: float, dnorm, rgb=None):
    """Edges [R, S + 1], raw density sums [R S, parts], the density bias,
    |direction| [R] and colours [R S, 3] or None -> (weights [R, S], colour
    [R, 3] or None); the last interval's length is 1e10."""
    r, s = tdist.shape[0], tdist.shape[1] - 1
    sig = torch.nn.functional.softplus(raw.sum(-1).reshape(r, s) + b_sigma - 1.0)
    dt = torch.cat([tdist[:, 1:-1] - tdist[:, :-2], torch.full_like(tdist[:, :1], 1e10)], -1)
    dd = sig * dt * dnorm[:, None]
    w = (1 - torch.exp(-dd)) * torch.exp(-torch.cat([torch.zeros_like(dd[:, :1]), torch.cumsum(dd[:, :-1], -1)], -1))
    color = None if rgb is None else (w[..., None] * rgb.reshape(r, s, 3)).sum(1)
    return w, color


def composite(tdist, raw, b_sigma: float, dnorm, rgb=None, need_weights: bool = True):
    """`composite_plain`, on the card K13 (weights only where needed)."""
    if tdist.device.type != "cuda":
        return composite_plain(tdist, raw, b_sigma, dnorm, rgb)
    r, s = tdist.shape[0], tdist.shape[1] - 1
    w = torch.empty((r, s), dtype=torch.float32, device=tdist.device) if need_weights else None
    color = torch.empty((r, 3), dtype=torch.float32, device=tdist.device) if rgb is not None else None
    null = ctypes.c_void_p(0)
    _build.launch(LIBRARY, "m360_composite_launch", tdist.data_ptr(), raw.data_ptr(), raw.shape[1], float(b_sigma),
                  dnorm.data_ptr(), null if rgb is None else rgb.data_ptr(), null if w is None else w.data_ptr(),
                  null if color is None else color.data_ptr(), r, s, _build.stream_handle(tdist.device))
    LAUNCHES["composite"] += 1
    return w, color


# ---------------------------------------------------------------------------
# The frame.

def ray_radii(dirs: torch.Tensor) -> torch.Tensor:
    """Directions [..., H, W, 3] of a pixel grid -> radii [..., H, W]: the
    distance to the next pixel's direction along a row (the last column's to
    the one before) x 2 / sqrt(12)."""
    dx = torch.linalg.norm(dirs[..., 1:, :] - dirs[..., :-1, :], dim=-1)
    dx = torch.cat([dx, dx[..., -1:]], -1)
    return dx * (2 / np.sqrt(12))


@torch.no_grad()
def render_rays_mip360(model: Mip360Model, origins, dirs, viewdirs, radii):
    """Rays [R, 3] (directions not normalised; viewdirs unit) and radii [R]
    in world units -> float32 colours [R, 3] (module note)."""
    spec, dev = model.spec, origins.device
    r = origins.shape[0]
    rp = -(-r // RAY_MULTIPLE) * RAY_MULTIPLE
    if rp > r:  # whole 128-row tiles on the card: the last ray repeated
        pad = lambda x: torch.cat([x, x[-1:].expand(rp - r, *x.shape[1:])])  # noqa: E731
        origins, dirs, viewdirs, radii = map(pad, (origins, dirs, viewdirs, radii))
    scale = np.float32(spec.scene_scale)
    o, d, rad = (origins / scale).contiguous(), (dirs / scale).contiguous(), (radii / scale).contiguous()
    dnorm = torch.linalg.norm(d, dim=-1).contiguous()
    cuda = dev.type == "cuda"
    n_view = model.params["nerf"]["view"]
    vray = _bf(view_encoding(viewdirs, spec.view_degrees)) @ _bf(n_view["w"][spec.bottleneck:]) + n_view["b"]
    vray = vray.contiguous()

    sdist = torch.tensor([0.0, 1.0], device=dev).expand(rp, 2).contiguous()
    weights = torch.ones((rp, 1), device=dev)
    levels = list(spec.prop_samples) + [spec.nerf_samples]
    prod, color = 1, None
    for level, n in enumerate(levels):
        nerf = level == len(levels) - 1
        dilation = spec.dilation_bias + spec.dilation_multiplier / prod if level > 0 else None
        prod *= n
        with span("m360.placement"):
            sdist, tdist = place(sdist, weights, dilation, n, spec)
        rows = rp * n
        parts = spec.nerf_width // 256 if nerf and cuda else 1
        raw = torch.empty((rows, parts), dtype=torch.float32, device=dev)
        rgb = torch.empty((rows, 3), dtype=torch.float32, device=dev) if nerf else None
        with span("m360.nerf" if nerf else "m360.proposal"):
            step = max(RAY_MULTIPLE, (CHUNK_ROWS // n) // RAY_MULTIPLE * RAY_MULTIPLE)
            for r0 in range(0, rp, step):
                r1 = min(rp, r0 + step)
                lo, hi = r0 * n, r1 * n
                with span("m360.encode"):
                    if cuda:
                        x = encode_slabs(o[r0:r1], d[r0:r1], rad[r0:r1], tdist[r0:r1].contiguous(), model)
                    else:
                        x = encode_plain(o[r0:r1], d[r0:r1], rad[r0:r1], tdist[r0:r1], model)
                if cuda and nerf:
                    nerf_slabs(model, x, hi - lo, vray[r0:r1], n, raw[lo:hi], rgb[lo:hi])
                elif cuda:
                    prop_density_slabs(model, x, hi - lo, raw[lo:hi])
                elif nerf:
                    raw[lo:hi], rgb[lo:hi] = nerf_plain(model, x, vray[r0:r1], n)
                else:
                    raw[lo:hi] = prop_density_plain(model, x)
        if profiler.tracing():
            profiler.count("render.m360_nerf_samples" if nerf else "render.m360_prop_samples", r * n)
        with span("m360.composite"):
            weights, color = composite(tdist, raw, model.b_sigma["nerf" if nerf else "prop"], dnorm, rgb,
                                       need_weights=not nerf)
    return color[:r]
