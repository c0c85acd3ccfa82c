"""int8 calibration and kernel parameters of the port against the JAX package:
the same weights and seed give the same floats, int8 weights, int32 biases
and shifts."""

import copy
import itertools
import math
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.infer.checkpoint import load_checkpoint as jload_checkpoint
from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.ops import pallas_render as jpr
from nerf_workspaces_explorer_tpu.ops import quantize as jq
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.ops import quantize as q

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = ("synth_hier", "room_proposal", "room_proposal.turbo")


def _load(name):
    params, _, _, _ = jload_checkpoint(os.path.join(ROOT, "assets", "bench", f"{name}.npz"))
    return params


def _port_tree(params):
    return params_from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float32), params))


@pytest.mark.parametrize("name", CKPTS)
def test_calibrate_model_quant_matches_jax(name):
    """Every maximum of every net, heads included, equal as floats."""
    params = _load(name)
    spec = jq.spec_from_net_params(params["fine"])
    ref = jq.calibrate_model_quant(params, spec)
    mine = q.calibrate_model_quant(_port_tree(params), q.spec_from_net_params(_port_tree(params)["fine"]))
    assert set(mine) == set(ref)
    for net in ref:
        assert tuple(mine[net]) == tuple(ref[net]), net
        assert mine[net].int8_heads


def _assert_kernel_params_equal(kp, ref):
    """Array-equal weights and biases (the port's [out] biases and 16-row rgb
    head against JAX's [out, 1] and 8 rows), equal shifts and scales."""
    pairs = list(zip(kp.w_layers, ref.w_layers)) + list(zip(kp.w_skip_enc, ref.w_skip_enc))
    pairs += [(b, rb[:, 0]) for b, rb in zip(kp.b_layers, ref.b_layers)]
    pairs += [(kp.w_fa, ref.w_fa), (kp.b_fa, ref.b_fa[:, 0]), (kp.w_view_h, ref.w_view_h),
              (kp.w_view_enc, ref.w_view_enc), (kp.b_view, ref.b_view[:, 0]),
              (kp.w_rgb[:8], ref.w_rgb), (kp.b_rgb[:8], ref.b_rgb[:, 0])]
    for mine, theirs in pairs:
        theirs = np.asarray(theirs)
        assert str(mine.dtype).split(".")[-1] == str(theirs.dtype), (mine.dtype, theirs.dtype)
        np.testing.assert_array_equal(mine.float().numpy(), theirs.astype(np.float32))
    assert not kp.w_rgb[8:].any()
    for field in ("shift_layers", "skip_shift", "feat_qscale", "int8_heads", "k_feat", "k_hv",
                  "s_alpha", "inv_s_view", "s_rgb", "skips", "width", "pts_freqs", "view_freqs"):
        assert getattr(kp, field) == getattr(ref, field), field


@pytest.mark.parametrize("heads", [True, False], ids=["int8", "int8-trunk"])
@pytest.mark.parametrize("name", CKPTS)
def test_prepare_kernel_params_int8_matches_jax(name, heads):
    params = _load(name)
    for net, tree in params.items():
        spec = jq.spec_from_net_params(tree)
        assert tuple(q.spec_from_net_params(_port_tree(tree))) == tuple(spec)
        quant = jq.calibrate_trunk(tree, spec, heads=heads)
        ref = jpr.prepare_kernel_params(tree, spec, quant=quant)
        mine = fr.prepare_kernel_params(
            _port_tree(tree), q.spec_from_net_params(_port_tree(tree)),
            quant=q.calibrate_trunk(_port_tree(tree), spec, heads=heads),
        )
        assert mine.mode == (fr.MODE_INT8 if heads else fr.MODE_INT8_TRUNK)
        _assert_kernel_params_equal(mine, ref)


def test_balanced_requant_matches_jax():
    """On tests/test_pallas.py:334's grid, and with its bounds."""
    sqrt2 = math.sqrt(2.0) + 1e-12
    for w_unit, in_unit, target in itertools.product(
        [1e-4, 3.7e-3, 0.11, 1.0], [1e-3, 0.42, 2.0], [1e-4, 9e-3, 0.3, 5.0, 77.0]
    ):
        unit, k = fr._balanced_requant(w_unit, in_unit, target)
        assert (unit, k) == jpr._balanced_requant(w_unit, in_unit, target)
        assert isinstance(k, int) and k >= 0 and w_unit <= unit <= w_unit * sqrt2


def test_dead_preskip_layer_matches_jax():
    """tests/test_pallas.py:255: a pre-skip layer that never fires on the
    calibration batch calibrates to 0, its unit anchors at the encoding's,
    and neither package warns; the shifts are equal and in range."""
    spec = JSpec()
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    dead = {"coarse": init_nerf_params(k1, spec), "fine": init_nerf_params(k2, spec)}
    for net in dead.values():
        net["alpha"]["b"] = net["alpha"]["b"] + 1.5
        net["pts"][spec.skips[0]]["b"] = net["pts"][spec.skips[0]]["b"] - 100.0
    ref_q = jq.calibrate_model_quant(copy.deepcopy(dead), spec, box=4.0, heads=False)
    mine_q = q.calibrate_model_quant(_port_tree(dead), q.spec_from_net_params(_port_tree(dead)["fine"]),
                                     box=4.0, heads=False)
    assert tuple(mine_q["fine"]) == tuple(ref_q["fine"])
    assert mine_q["fine"].h_max[spec.skips[0]] == 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = jpr.prepare_kernel_params(dead["fine"], spec, quant=ref_q["fine"])
        mine = fr.prepare_kernel_params(_port_tree(dead)["fine"], q.spec_from_net_params(_port_tree(dead)["fine"]),
                                        quant=mine_q["fine"])
    assert all(-8 <= j <= 8 for j in mine.skip_shift)
    _assert_kernel_params_equal(mine, ref)


def test_int_dot_is_exact():
    """The plain int8 products run in float64 (no int32 matmul on the card):
    equal to an int64 matmul at the widest input, 320 = 256 + 64 (skip)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (512, 320), generator=g, dtype=torch.int32)
    w = torch.randint(-127, 128, (256, 320), generator=g, dtype=torch.int8)
    assert torch.equal(fr._int_dot(a, w), (a.long() @ w.long().T).to(torch.int32))
