"""Static int8 calibration for the fused render kernel (trunk + heads).

Counterpart of `nerf_workspaces_explorer_tpu/ops/quantize.py`, kept in numpy
so that the same weights and seed give the same floats in both packages.

Scheme: per-tensor symmetric int8 with static calibration. Weights quantize
as round(w / (max|w| / 127)); activations as clip(round(h / unit), 0, 127)
([-127, 127] for the activation-free feature head), with their maxima
measured once, at model load, by pushing a batch of scene points and unit
view directions through the fp32 network. The activation units are powers
of two of the incoming accumulator's scale, so every requantization inside
the kernel is an integer `clip((acc + b_i32) >> k, lo, 127)`
(`ops/fused_render.py::prepare_kernel_params`).

`heads=True` (precision "int8") calibrates the feature, alpha, view and rgb
heads too, so every per-sample product runs int8; `heads=False`
("int8-trunk") quantizes only the density trunk.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec


class TrunkQuant(NamedTuple):
    """Calibration maxima of one network (plain floats)."""

    feat_max: float  # max |encoded feature| (layer-0 / skip input)
    h_max: Tuple[float, ...]  # per-layer activation max, layers 0..D-2
    w_max: Tuple[float, ...]  # per-layer |weight| max, layers 0..D-1
    skip_w_max: Tuple[float, ...]  # per skip-layer encoding-weight max
    # int8-head fields (None: the heads stay bf16)
    h_last_max: Optional[float] = None  # final trunk activation max
    feature_max: Optional[float] = None  # |feature head output| max (signed)
    hv_max: Optional[float] = None  # view-layer activation max (post-relu)
    w_feat_max: Optional[float] = None  # |feature head weight| max
    w_alpha_max: Optional[float] = None  # |alpha head weight| max
    w_view_h_max: Optional[float] = None  # |view-layer h-block weight| max
    w_rgb_max: Optional[float] = None  # |rgb head weight| max

    @property
    def int8_heads(self) -> bool:
        return self.h_last_max is not None


def as_float32_array(x: Any) -> np.ndarray:
    """A tensor (any device or dtype) or array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _encode_np(pts: np.ndarray, num_freqs: int, scalar_factor: float) -> np.ndarray:
    """Reference-ordered positional encoding in numpy (embedding.py:24-38).
    Only magnitudes matter for calibration; the kernel's row order keeps
    them."""
    x = pts / scalar_factor
    feats = [x]
    for k in range(num_freqs):
        feats.append(np.sin(2.0**k * x))
        feats.append(np.cos(2.0**k * x))
    return np.concatenate(feats, axis=-1)


def calibrate_trunk(
    params: Dict[str, Any],
    spec: Optional[NerfMLPSpec] = None,
    *,
    seed: int = 0,
    n_points: int = 4096,
    box: float = 8.0,
    margin: float = 1.05,
    heads: bool = True,
    pts: Optional[np.ndarray] = None,
    percentile: Optional[float] = 99.5,
) -> TrunkQuant:
    """Trunk (and, with `heads`, head) activation and weight maxima of one
    network on a batch of scene points: U(-box, box)^3 from `seed`, or the
    given `pts` [N, 3]; view directions uniform on the sphere. Activation
    maxima are the `percentile` of the nonzero activations (None: the exact
    maximum) times `margin`; weight maxima are always exact."""
    if spec is None:
        spec = NerfMLPSpec()
    rng = np.random.default_rng(seed)
    if pts is None:
        pts = rng.uniform(-box, box, size=(n_points, 3)).astype(np.float32)
    else:
        pts = np.asarray(pts, dtype=np.float32).reshape(-1, 3)
        n_points = pts.shape[0]

    def amax(x: np.ndarray) -> float:
        a = np.abs(x)
        if percentile is None:
            return float(a.max())
        # Over the nonzero support: post-ReLU activations can be >99.5%
        # zeros on points outside the trained geometry, and a percentile of
        # zero would clip every real activation.
        nz = a[a > 0.0]
        if nz.size == 0:
            return 0.0
        return float(np.percentile(nz, percentile))

    num_freqs = (spec.input_ch - 3) // 6
    feat = _encode_np(pts, num_freqs, 10.0)

    feat_max = amax(feat)
    h = feat
    h_max, w_max, skip_w_max = [], [], []
    for i, layer in enumerate(params["pts"]):
        w = as_float32_array(layer["w"])  # [in, out]
        b = as_float32_array(layer["b"])
        if i > 0 and (i - 1) in spec.skips:
            # Concat order [input_pts, h] (reference nerf_model.py:59).
            skip_w_max.append(float(np.max(np.abs(w[: spec.input_ch]))))
            w_max.append(float(np.max(np.abs(w[spec.input_ch :]))))
            h = np.concatenate([feat, h], axis=-1)
        else:
            w_max.append(float(np.max(np.abs(w))))
        h = np.maximum(h @ w + b, 0.0)
        if i < len(params["pts"]) - 1:
            h_max.append(amax(h) * margin)

    if not heads or not spec.use_view_dirs or "feature" not in params:
        return TrunkQuant(
            feat_max=feat_max * margin,
            h_max=tuple(h_max),
            w_max=tuple(w_max),
            skip_w_max=tuple(skip_w_max),
        )

    # The same batch through feature/view/rgb with a random unit view
    # direction per point (reference nerf_model.py:61-76).
    w_f, b_f = as_float32_array(params["feature"]["w"]), as_float32_array(params["feature"]["b"])
    w_a = as_float32_array(params["alpha"]["w"])
    w_v, b_v = as_float32_array(params["views"][0]["w"]), as_float32_array(params["views"][0]["b"])
    w_r = as_float32_array(params["rgb"]["w"])

    feature = h @ w_f + b_f
    dirs = rng.normal(size=(n_points, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-9
    view_freqs = (spec.input_ch_views - 3) // 6
    venc = _encode_np(dirs, view_freqs, 1.0)
    hv = np.maximum(np.concatenate([feature, venc], axis=-1) @ w_v + b_v, 0.0)

    return TrunkQuant(
        feat_max=feat_max * margin,
        h_max=tuple(h_max),
        w_max=tuple(w_max),
        skip_w_max=tuple(skip_w_max),
        h_last_max=amax(h) * margin,
        feature_max=amax(feature) * margin,
        hv_max=amax(hv) * margin,
        w_feat_max=float(np.max(np.abs(w_f))),
        w_alpha_max=float(np.max(np.abs(w_a))),
        w_view_h_max=float(np.max(np.abs(w_v[: spec.width]))),
        w_rgb_max=float(np.max(np.abs(w_r))),
    )


def spec_from_net_params(net: Dict[str, Any]) -> NerfMLPSpec:
    """A net's architecture from its parameter shapes: a proposal-mode tree
    mixes a 2x64 proposal net with a wider fine net, and each is walked
    with its own dimensions."""
    in_ch = int(net["pts"][0]["w"].shape[0])
    width = int(net["pts"][0]["w"].shape[1])
    depth = len(net["pts"])
    skips = tuple(
        i - 1 for i in range(1, depth) if int(net["pts"][i]["w"].shape[0]) == width + in_ch
    )
    use_view_dirs = bool(net.get("views"))
    in_views = int(net["views"][0]["w"].shape[0]) - width if use_view_dirs else 27
    return NerfMLPSpec(
        depth=depth,
        width=width,
        input_ch=in_ch,
        input_ch_views=in_views,
        skips=skips,
        use_view_dirs=use_view_dirs,
    )


def calibrate_model_quant(
    params: Dict[str, Any], spec: Optional[NerfMLPSpec] = None, **kw
) -> Dict[str, TrunkQuant]:
    """Per-network calibration of a {"coarse" or "proposal", "fine"} tree.
    A net whose shapes disagree with `spec` (the proposal net) calibrates
    with the spec read from its own parameters."""
    if spec is None:
        spec = NerfMLPSpec()

    def net_spec(net):
        inferred = spec_from_net_params(net)
        return spec if inferred == spec else inferred

    return {
        name: calibrate_trunk(net, net_spec(net), **kw)
        for name, net in params.items()
        if isinstance(net, dict) and "pts" in net
    }
