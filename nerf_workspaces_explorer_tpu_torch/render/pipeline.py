"""Coarse+fine hierarchical rendering in plain PyTorch.

Counterpart of `nerf_workspaces_explorer_tpu/render/pipeline.py`. Eval mode
(reference nerf/inference/nerf_replica_inference_handler.py:203-277) is the
fp32 "parity" precision: 64 linear coarse depths through the coarse net,
deterministic inverse-CDF importance samples from its weights, the sorted
union through the fine net, compositing. Training mode (reference
nerf/training/nerf_replica_training_handler.py:534-618) adds stratified
jitter of the coarse depths, sigma noise before the ReLU and importance
samples at random quantiles; its random tensors come in as `RenderDraws`,
so a test can hand both packages the same draws.

The field (encode + MLP) is `settings.field_impl`: "plain", the fp32
`apply_nerf_mlp` that autograd differentiates (the JAX package's "xla"), or
"fused", the K4/K5 kernels of `ops/fused_field.py` (its "pallas").

Two serving extensions change the placement (JAX pipeline.py:60-84,
:195-242): `use_proposal` evaluates a small proposal net
(`render/proposal.py`) in the coarse net's place, and `merge_coarse=False`
(the fast and turbo presets) gives the fine net only the importance samples.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Union

import torch

from nerf_workspaces_explorer_tpu_torch.models.encoding import positional_encoding
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLP, NerfMLPSpec, apply_nerf_mlp
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle
from nerf_workspaces_explorer_tpu_torch.rays.sampling import (
    coarse_z_vals,
    merge_sorted_z,
    sample_pdf,
    stratified_perturb,
)
from nerf_workspaces_explorer_tpu_torch.render.volume import composite_rays

FIELD_IMPLS = ("plain", "fused")


class RenderSettings(NamedTuple):
    """Rendering hyperparameters (defaults: reference office_tokyo_config.yaml:20-31)."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_background: bool = False
    num_freqs_3d: int = 10
    num_freqs_2d: int = 4
    use_view_dirs: bool = True
    train: bool = False  # enables perturb/noise/random importance quantiles
    field_impl: str = "plain"
    # The proposal net (render/proposal.py) in the coarse net's place.
    use_proposal: bool = False
    proposal_num_freqs: int = 6
    # True: the fine net sees sort(cat(z_vals, z_samples)), as the reference
    # (…inference_handler.py:243); False: the importance samples only.
    merge_coarse: bool = True
    # Fused path only: the density pass and the placement run on every s-th
    # ray per image axis, and each s x s block shares its corner's fine
    # depths (ops/fused_render.py::render_rays_fused); 1 is exact placement.
    proposal_subsample: int = 1

    @property
    def deterministic_importance(self) -> bool:
        # Reference: det = (perturb == 0.) or (not train_mode) (…training_handler.py:579).
        return (self.perturb == 0.0) or (not self.train)

    def for_eval(self) -> "RenderSettings":
        """Inference variant: no perturbation, no sigma noise, det sampling."""
        return self._replace(train=False, raw_noise_std=0.0)


class RenderDraws(NamedTuple):
    """The random tensors of one training-mode render of R rays, in the
    order the JAX package splits its key: stratified jitter U[0, 1) [R, S],
    coarse and fine sigma noise N(0, 1) [R, S] and [R, S + I], importance
    quantiles U[0, 1) [R, I]."""

    t_rand: torch.Tensor
    noise_coarse: torch.Tensor
    noise_fine: torch.Tensor
    u: torch.Tensor


def draw_render_randoms(
    gen: torch.Generator, n_rays: int, settings: RenderSettings, device: torch.device
) -> RenderDraws:
    """One training-mode render's draws from `gen`, on `device`."""
    s, i = settings.n_samples, settings.n_importance
    return RenderDraws(
        t_rand=torch.rand((n_rays, s), generator=gen, device=device),
        noise_coarse=torch.randn((n_rays, s), generator=gen, device=device),
        noise_fine=torch.randn((n_rays, s + i if settings.merge_coarse else i), generator=gen, device=device),
        u=torch.rand((n_rays, i), generator=gen, device=device),
    )


Model = Union[NerfMLP, Dict[str, Any]]


def _eval_network(
    model: Model, spec: Optional[NerfMLPSpec], pts: torch.Tensor, viewdirs: torch.Tensor,
    settings: RenderSettings,
) -> torch.Tensor:
    """Encode [R, S, 3] points (+ per-ray viewdirs [R, 3]) -> raw [R, S, 4]
    through a NerfMLP or a parameter tree with its spec."""
    if isinstance(model, NerfMLP):
        params, spec = model.tree(), model.spec
    else:
        params = model
        spec = spec or NerfMLPSpec(use_view_dirs=settings.use_view_dirs)
    if settings.field_impl == "fused":
        # The fused field derives its encoding from the spec: refuse settings
        # that disagree rather than train with other frequencies.
        if (3 * (1 + 2 * settings.num_freqs_3d), 3 * (1 + 2 * settings.num_freqs_2d)) != (
            spec.input_ch, spec.input_ch_views
        ):
            raise ValueError(
                f"num_freqs {settings.num_freqs_3d}/{settings.num_freqs_2d} disagree with the "
                f"spec's input widths {spec.input_ch}/{spec.input_ch_views}"
            )
        from nerf_workspaces_explorer_tpu_torch.ops.fused_field import fused_field

        n_rays, n_samples = pts.shape[0], pts.shape[1]
        views = viewdirs[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
        raw = fused_field(params, spec, pts.reshape(-1, 3), views)
        return raw.reshape(n_rays, n_samples, 4)
    if settings.field_impl != "plain":
        raise ValueError(f"unknown field_impl {settings.field_impl!r} ({'|'.join(FIELD_IMPLS)})")
    encoded_pts = positional_encoding(pts, settings.num_freqs_3d, scalar_factor=10.0)
    encoded_views = None
    if settings.use_view_dirs:
        enc = positional_encoding(viewdirs, settings.num_freqs_2d, scalar_factor=1.0)
        encoded_views = enc[:, None, :].expand(pts.shape[0], pts.shape[1], enc.shape[-1])
    return apply_nerf_mlp(params, spec, encoded_pts, encoded_views)


def render_ray_bundle(
    models: Mapping[str, Model],
    rays: RayBundle,
    settings: RenderSettings,
    *,
    spec: Optional[NerfMLPSpec] = None,
    draws: Optional[RenderDraws] = None,
    full_outputs: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render a flat bundle [R] through {"coarse" or "proposal", "fine"} nets
    (NerfMLPs, or parameter trees of architecture `spec`; a proposal tree
    has `proposal_spec`'s).

    Training mode (`settings.train`) needs `draws` for its jitter, noise and
    importance quantiles. Returns the reference's output names
    (…inference_handler.py:256-268): rgb/disp/acc/depth `_fine`, plus the
    `_coarse` maps when `full_outputs` or when there is no importance pass;
    `full_outputs` adds raw, weights and z_vals of both passes and z_std.
    """
    train = settings.train
    if train and draws is None and (settings.perturb > 0.0 or settings.raw_noise_std > 0.0):
        raise ValueError("training-mode rendering requires draws")
    noise_std = settings.raw_noise_std if train else 0.0
    z_vals = coarse_z_vals(rays.near, rays.far, settings.n_samples)  # [R, S]
    if train and settings.perturb > 0.0:
        z_vals = stratified_perturb(z_vals, draws.t_rand)
    viewdirs = rays.viewdirs
    pts = rays.origins[..., None, :] + rays.dirs[..., None, :] * z_vals[..., :, None]
    if settings.use_proposal:
        # Its rgb is never used; its sigma drives the importance weights.
        from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

        prop_settings = settings._replace(num_freqs_3d=settings.proposal_num_freqs, num_freqs_2d=2)
        raw_coarse = _eval_network(
            models["proposal"], proposal_spec(settings.proposal_num_freqs), pts, viewdirs,
            prop_settings,
        )
    else:
        raw_coarse = _eval_network(models["coarse"], spec, pts, viewdirs, settings)
    out_coarse = composite_rays(
        raw_coarse, z_vals, rays.dirs, raw_noise_std=noise_std,
        noise=None if draws is None else draws.noise_coarse,
        white_background=settings.white_background,
    )
    outputs: Dict[str, torch.Tensor] = {}
    if settings.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        u = None if settings.deterministic_importance else draws.u
        z_samples = sample_pdf(
            z_mid, out_coarse.weights[..., 1:-1], settings.n_importance, u=u
        ).detach()  # the reference detaches (…training_handler.py:580)
        if settings.merge_coarse:
            z_fine = merge_sorted_z(z_vals, z_samples)
        elif settings.deterministic_importance:
            z_fine = z_samples  # ascending quantiles give ascending depths
        else:
            z_fine = torch.sort(z_samples, -1).values
        pts = rays.origins[..., None, :] + rays.dirs[..., None, :] * z_fine[..., :, None]
        raw_fine = _eval_network(models["fine"], spec, pts, viewdirs, settings)
        out_fine = composite_rays(
            raw_fine, z_fine, rays.dirs, raw_noise_std=noise_std,
            noise=None if draws is None else draws.noise_fine,
            white_background=settings.white_background,
        )
        outputs.update(
            rgb_fine=out_fine.rgb, disp_fine=out_fine.disp,
            acc_fine=out_fine.acc, depth_fine=out_fine.depth,
        )
        if full_outputs:
            outputs.update(
                raw_fine=raw_fine, weights_fine=out_fine.weights, z_vals_fine=z_fine,
                z_std=torch.std(z_samples, dim=-1, unbiased=False),
            )
    if full_outputs or settings.n_importance == 0:
        outputs.update(
            rgb_coarse=out_coarse.rgb, disp_coarse=out_coarse.disp,
            acc_coarse=out_coarse.acc, depth_coarse=out_coarse.depth,
        )
        if full_outputs:
            outputs.update(
                raw_coarse=raw_coarse, weights_coarse=out_coarse.weights, z_vals_coarse=z_vals
            )
    return outputs


@torch.no_grad()
def render_rays_chunked(
    models: Mapping[str, Model],
    rays: RayBundle,
    settings: RenderSettings,
    *,
    spec: Optional[NerfMLPSpec] = None,
    chunk: int = 8192,
    full_outputs: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render a large flat bundle in `chunk`-ray tiles (reference
    utils/batch_utils.py:7-25; inference chunk 8192). The ray count is padded
    to a multiple of `chunk` by repeating the last ray, as the JAX package
    does, so every tile has one shape and padded lanes stay finite.
    `full_outputs` as `render_ray_bundle`'s."""
    n = rays.origins.shape[0]
    padded = -(-n // chunk) * chunk

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x[-1:].expand(padded - n, *x.shape[1:])], 0)

    rays = RayBundle(*(pad(field) for field in rays))
    tiles = [
        render_ray_bundle(models, rays[i : i + chunk], settings.for_eval(), spec=spec, full_outputs=full_outputs)
        for i in range(0, padded, chunk)
    ]
    return {k: torch.cat([t[k] for t in tiles], 0)[:n] for k in tiles[0]}
