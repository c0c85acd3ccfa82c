"""Plain float32 NeRF training steps: the yardstick the benchmark's training
steps are judged against.

NeRF's training step (arXiv:2003.08934, sec. 5.3 and App. A; the reference
application's step): one training image drawn per step and `n_rays` of its
pixels (with replacement), 64 stratified coarse depths, the sigma noise of
the raw density, 128 importance depths drawn by inverse CDF from the coarse
weights (detached) and merged with the coarse ones, the sum of the coarse
and fine MSEs, and one Adam step (b1 0.9, b2 0.999, eps 1e-8) at the rate
lr * 0.1 ** (step / 50,000). Products in float32 with TF32 off.

A step's random numbers are derived again here from the run's seed and
the step, the way the reference application's port draws them: a
generator on the step's device seeded from `SeedSequence([seed, step])`,
then the image index, the pixels, the jitter, the coarse and fine noise and
the importance quantiles, in that order. Nothing of the program is
imported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from reference import nerf

Tree = Dict[str, torch.Tensor]  # "<net>/<layer>/<w|b>" -> leaf


class Draws(NamedTuple):
    img: torch.Tensor
    pix: torch.Tensor
    t_rand: torch.Tensor
    noise_coarse: torch.Tensor
    noise_fine: torch.Tensor
    u: torch.Tensor


def step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


def draws(seed: int, step: int, n_img: int, hw: int, n_rays: int, n_samples: int, n_importance: int,
          merge: bool, device) -> Draws:
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    img = torch.randint(0, n_img, (), generator=gen, device=device)
    pix = torch.randint(0, hw, (n_rays,), generator=gen, device=device)
    t_rand = torch.rand((n_rays, n_samples), generator=gen, device=device)
    noise_c = torch.randn((n_rays, n_samples), generator=gen, device=device)
    noise_f = torch.randn((n_rays, n_samples + n_importance if merge else n_importance), generator=gen,
                          device=device)
    u = torch.rand((n_rays, n_importance), generator=gen, device=device)
    return Draws(img, pix, t_rand, noise_c, noise_f, u)


def layer_names(net: dict) -> List[tuple]:
    """(layer name, in, out) of one MLP of the configuration's shape."""
    w, half = net["width"], net["width"] // 2
    d_in, v_in = 3 * (1 + 2 * net["pts_freqs"]), 3 * (1 + 2 * net["view_freqs"])
    out = [("pts/0", d_in, w)]
    for i in range(1, net["depth"]):
        out.append((f"pts/{i}", w + d_in if (i - 1) in net["skips"] else w, w))
    return out + [("alpha", w, 1), ("feature", w, w), ("views/0", w + v_in, half), ("rgb", half, 3)]


def init_weights(nets: dict, seed: int, device) -> Tree:
    """Every net's weights and biases, U(-1/sqrt(in), 1/sqrt(in)) (PyTorch's
    nn.Linear default), from one draw of a generator on `device` seeded
    from `seed`."""
    shapes = [(f"{net}/{name}/{wb}", (i, o) if wb == "w" else (o,), i)
              for net in sorted(nets) for name, i, o in layer_names(nets[net]) for wb in ("w", "b")]
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), 5]).generate_state(1)[0]))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    tree, at = {}, 0
    for key, shape, fan_in in shapes:
        n = math.prod(shape)
        tree[key] = (flat[at : at + n].reshape(shape) / math.sqrt(fan_in)).contiguous()
        at += n
    return tree


def as_net(tree: Tree, name: str, net: dict) -> nerf.Net:
    def layer(key):
        return tree[f"{name}/{key}/w"], tree[f"{name}/{key}/b"]

    return nerf.Net(trunk=[layer(f"pts/{i}") for i in range(net["depth"])], skips=tuple(net["skips"]),
                    alpha=layer("alpha"), feature=layer("feature"), views=[layer("views/0")], rgb=layer("rgb"),
                    pts_freqs=net["pts_freqs"], view_freqs=net["view_freqs"])


def _raw(net: nerf.Net, pts, viewdirs, matmul):
    enc = nerf.encode(pts, net.pts_freqs, 10.0)
    h = enc
    for i, (w, b) in enumerate(net.trunk):
        h = torch.relu(matmul(h, w) + b)
        if i in net.skips:
            h = torch.cat([enc, h], -1)
    sigma = (matmul(h, net.alpha[0]) + net.alpha[1])[..., 0]
    venc = nerf.encode(viewdirs, net.view_freqs, 1.0)[..., None, :].expand(*pts.shape[:-1], -1)
    h = torch.cat([matmul(h, net.feature[0]) + net.feature[1], venc], -1)
    h = torch.relu(matmul(h, net.views[0][0]) + net.views[0][1])
    return sigma, torch.sigmoid(matmul(h, net.rgb[0]) + net.rgb[1])


def _composite(sigma, rgb, z, dnorm, noise):
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm[:, None]
    alpha = 1.0 - torch.exp(-torch.relu(sigma + noise) * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    weights = alpha * trans
    return (weights[..., None] * rgb).sum(1), weights


def _inverse_cdf_at(z, weights, u):
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = weights[:, 1:-1] + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def loss(tree: Tree, nets: dict, origins, dirs, viewdirs, gt, d: Draws, spec: dict,
         matmul: Callable = torch.matmul) -> torch.Tensor:
    """Coarse + fine MSE of one batch of rays [R, 3] against gt [R, 3]."""
    n_s = spec["n_samples"]
    t = torch.arange(n_s, dtype=torch.float32, device=origins.device) * (1.0 / (n_s - 1))
    z = (spec["near"] * (1.0 - t) + spec["far"] * t).expand(origins.shape[0], n_s)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper, lower = torch.cat([mids, z[:, -1:]], -1), torch.cat([z[:, :1], mids], -1)
    z = lower + (upper - lower) * d.t_rand
    dnorm = torch.linalg.norm(dirs, dim=-1)
    coarse = as_net(tree, "coarse", nets["coarse"])
    fine = as_net(tree, "fine", nets["fine"])
    noise = spec["raw_noise_std"]
    s_c, c_c = _raw(coarse, origins[:, None] + dirs[:, None] * z[..., None], viewdirs, matmul)
    rgb_c, w_c = _composite(s_c, c_c, z, dnorm, d.noise_coarse * noise)
    z_s = _inverse_cdf_at(z.detach(), w_c.detach(), d.u).detach()
    z_f = torch.sort(torch.cat([z, z_s], -1), -1).values
    s_f, c_f = _raw(fine, origins[:, None] + dirs[:, None] * z_f[..., None], viewdirs, matmul)
    rgb_f, _ = _composite(s_f, c_f, z_f, dnorm, d.noise_fine * noise)
    return torch.mean((rgb_c - gt) ** 2) + torch.mean((rgb_f - gt) ** 2)


class StepRecord(NamedTuple):
    losses: List[float]
    first_grad: Tree  # the gradient of the first step
    params: Tree  # the parameters after the steps
    m: Tree  # Adam's first moment after the steps
    v: Tree  # and its second


def run_steps(tree: Tree, nets: dict, rays: dict, rgbs: torch.Tensor, seed: int, n_steps: int, spec: dict,
              matmul: Callable = torch.matmul, start_step: int = 0,
              moments: Optional[tuple] = None) -> StepRecord:
    """Steps start_step .. start_step + n_steps - 1 from `tree` (not
    modified) and Adam's moments `moments` = (m, v) after start_step
    updates (zeros where None): rays {"origins", "dirs", "viewdirs"}
    [N_img, H W, 3], rgbs [N_img, H W, 3]."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tree.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    else:
        m = {k: moments[0][k].detach().clone().to(params[k].device) for k in params}
        v2 = {k: moments[1][k].detach().clone().to(params[k].device) for k in params}
    n_img, hw = rgbs.shape[0], rgbs.shape[1]
    losses, first = [], None
    with nerf.fp32_matmuls():
        for step in range(start_step, start_step + n_steps):
            d = draws(seed, step, n_img, hw, spec["n_rays"], spec["n_samples"], spec["n_importance"], True,
                      rgbs.device)
            flat = d.img * hw + d.pix
            o, dr, vd = (rays[k].reshape(-1, 3)[flat] for k in ("origins", "dirs", "viewdirs"))
            value = loss(params, nets, o, dr, vd, rgbs.reshape(-1, 3)[flat], d, spec, matmul)
            grads = torch.autograd.grad(value, list(params.values()))
            losses.append(float(value.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(params, grads)}
            lr = spec["learning_rate"] * 0.1 ** (step / 50_000.0)
            t = step + 1
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(0.9).add_(g, alpha=0.1)
                    v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                    denom = (v2[k] / (1 - 0.999**t)).sqrt() + 1e-8
                    p.sub_(lr * (m[k] / (1 - 0.9**t)) / denom)
    return StepRecord(losses, first, {k: v.detach() for k, v in params.items()}, m, v2)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to float8 e4m3 (each scaled by its
    largest magnitude onto the format's 448), the products summed in
    float32; the backward's two products likewise."""
    return _Fp8Matmul.apply(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _fp8(a) @ _fp8(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = _fp8(grad)
        return g @ _fp8(b).transpose(-1, -2), _fp8(a).transpose(-1, -2) @ g


def leaf_gaps(prog: Tree, ref: Tree, keep: Optional[List[str]] = None) -> List[float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of the reference leaf's
    norm and the median leaf's."""
    keys = keep if keep is not None else list(ref)
    norms = {k: float(ref[k].norm()) for k in ref}
    median = float(np.median(list(norms.values())))
    return [abs(float(prog[k].norm()) - norms[k]) / max(norms[k], median) for k in keys]
