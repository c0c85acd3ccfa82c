"""The fused training field (K4/K5) against the JAX package's custom-VJP
field, run as tests/test_pallas_train.py runs it (interpret mode on the
CPU): on a CPU tensor the port's wrapper runs its plain, bf16-modelling
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.models import NerfMLPSpec as JSpec
from nerf_workspaces_explorer_tpu.models import apply_nerf_mlp as japply
from nerf_workspaces_explorer_tpu.models import init_nerf_params
from nerf_workspaces_explorer_tpu.models.encoding import positional_encoding as jencode
from nerf_workspaces_explorer_tpu.ops import pallas_train as jpt
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.models.encoding import positional_encoding
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, apply_nerf_mlp, tree_leaves
from nerf_workspaces_explorer_tpu_torch.ops import fused_field as ff

torch.set_num_threads(2)

SMALL = dict(depth=4, width=64, input_ch=39, input_ch_views=15)  # F = 6 / 2
# The distilled students (train/distill.py), each a field library of its own.
STUDENTS = {"6x192@10f": dict(depth=6, width=192), "4x128@8f": dict(depth=4, width=128, input_ch=51)}
BF16_ATOL = 5e-3  # bf16 weights (tests/test_pallas_train.py:40)
BF16_GRAD_REL = 0.08  # bf16 recompute + bf16 grad products (:54-56)


def _inputs(seed, n=256):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    tgt = rng.normal(size=(n, 4)).astype(np.float32)
    return pts, vd, tgt


def _trees(spec_kwargs, seed=0):
    params = init_nerf_params(jax.random.PRNGKey(seed), JSpec(**spec_kwargs))
    mine = params_from_numpy(jax.tree.map(np.asarray, params))
    for leaf in tree_leaves(mine):
        leaf.requires_grad_(True)
    return params, mine


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _port_grads(fn, mine, pts, vd, tgt):
    out = fn(mine, torch.from_numpy(pts), torch.from_numpy(vd))
    loss = torch.mean((out - torch.from_numpy(tgt)) ** 2)
    grads = torch.autograd.grad(loss, tree_leaves(mine))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, params, pts, vd, tgt):
    out = np.asarray(fn(params, jnp.asarray(pts), jnp.asarray(vd)))
    g = jax.grad(lambda p: jnp.mean((fn(p, jnp.asarray(pts), jnp.asarray(vd)) - tgt) ** 2))(params)
    return out, [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@pytest.mark.parametrize("skips", [(4,), (0,), (1,), (2,)], ids=["no-skip", "skip1", "skip2", "skip3"])
def test_fused_field_matches_jax_kernels(skips):
    """Forward within the bf16 bound, every gradient leaf within rel 0.08 of
    JAX's interpret-mode kernels; skips=(4,) is vacuous at depth 4, the
    others put the skip concat before each of layers 1-3."""
    spec_kwargs = dict(SMALL, skips=skips)
    params, mine = _trees(spec_kwargs, seed=len(skips) + skips[0])
    pts, vd, tgt = _inputs(1)
    jfield = jpt.make_field_train_fn(JSpec(**spec_kwargs), row_tile=128, interpret=True)
    spec = NerfMLPSpec(**spec_kwargs)
    out, grads = _port_grads(lambda p, x, v: ff.fused_field(p, spec, x, v), mine, pts, vd, tgt)
    ref_out, ref_grads = _jax_grads(jfield, params, pts, vd, tgt)
    np.testing.assert_allclose(out, ref_out, atol=BF16_ATOL)
    assert len(grads) == len(ref_grads)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        assert a.shape == b.shape
        assert _rel(a, b) < BF16_GRAD_REL, (i, _rel(a, b))


def test_fused_field_at_the_proposal_shape_matches_jax_kernels():
    """The 2x64@6f/2f proposal net (no skip; `proposal_spec(6)`), the shape
    of its own field library: forward within the bf16 bound, every gradient
    leaf within rel 0.08 of JAX's interpret-mode
    `make_field_train_fn(proposal_spec(6))`."""
    from nerf_workspaces_explorer_tpu.render.proposal import proposal_spec as jproposal_spec
    from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

    jspec, spec = jproposal_spec(6), proposal_spec(6)
    params = init_nerf_params(jax.random.PRNGKey(11), jspec)
    mine = params_from_numpy(jax.tree.map(np.asarray, params))
    for leaf in tree_leaves(mine):
        leaf.requires_grad_(True)
    pts, vd, tgt = _inputs(12)
    jfield = jpt.make_field_train_fn(jspec, row_tile=128, interpret=True)
    out, grads = _port_grads(lambda p, x, v: ff.fused_field(p, spec, x, v), mine, pts, vd, tgt)
    ref_out, ref_grads = _jax_grads(jfield, params, pts, vd, tgt)
    np.testing.assert_allclose(out, ref_out, atol=BF16_ATOL)
    assert len(grads) == len(ref_grads)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        assert a.shape == b.shape
        assert _rel(a, b) < BF16_GRAD_REL, (i, _rel(a, b))


@pytest.mark.parametrize("student", STUDENTS)
def test_fused_field_at_the_student_shapes_matches_jax_kernels(student):
    """Each distilled student's shape (its own field library on the card):
    forward within the bf16 bound, every gradient leaf within rel 0.08 of
    JAX's interpret-mode kernels, as the 4x64 and proposal cases."""
    spec_kwargs = STUDENTS[student]
    params, mine = _trees(spec_kwargs, seed=14)
    pts, vd, tgt = _inputs(15)
    jfield = jpt.make_field_train_fn(JSpec(**spec_kwargs), row_tile=128, interpret=True)
    spec = NerfMLPSpec(**spec_kwargs)
    out, grads = _port_grads(lambda p, x, v: ff.fused_field(p, spec, x, v), mine, pts, vd, tgt)
    ref_out, ref_grads = _jax_grads(jfield, params, pts, vd, tgt)
    np.testing.assert_allclose(out, ref_out, atol=BF16_ATOL)
    assert len(grads) == len(ref_grads)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        assert a.shape == b.shape
        assert _rel(a, b) < BF16_GRAD_REL, (i, _rel(a, b))


def test_fused_field_matches_f32_reference():
    """The fused field against JAX's fp32 encode + MLP on the inputs of the
    JAX package's own kernel test (tests/test_pallas_train.py:20-56), to
    its bounds. The bound is the bf16 algorithm's and depends on the data:
    both packages' kernels agree to 1e-4 on any input (the test above)."""
    params = init_nerf_params(jax.random.PRNGKey(0), JSpec(**SMALL))
    mine = params_from_numpy(jax.tree.map(np.asarray, params))
    for leaf in tree_leaves(mine):
        leaf.requires_grad_(True)
    pts = np.array(jax.random.normal(jax.random.PRNGKey(1), (256, 3)) * 2.0)
    vd = jax.random.normal(jax.random.PRNGKey(2), (256, 3))
    vd = np.array(vd / jnp.linalg.norm(vd, axis=-1, keepdims=True))
    tgt = np.array(jax.random.normal(jax.random.PRNGKey(3), (256, 4)))
    spec = NerfMLPSpec(**SMALL)

    def jref(p, x, v):
        return japply(p, JSpec(**SMALL), jencode(x, 6, 10.0), jencode(v, 2, 1.0))

    out, grads = _port_grads(lambda p, x, v: ff.fused_field(p, spec, x, v), mine, pts, vd, tgt)
    ref_out, ref_grads = _jax_grads(jref, params, pts, vd, tgt)
    np.testing.assert_allclose(out, ref_out, atol=BF16_ATOL)
    for a, b in zip(grads, ref_grads):
        assert _rel(a, b) < BF16_GRAD_REL


def test_plain_f32_field_matches_jax():
    """The f32 plain field (field_impl="plain"): forward atol 1e-5, gradients
    rel 1e-4 against JAX's encode + apply_nerf_mlp."""
    params, mine = _trees(SMALL, seed=4)
    pts, vd, tgt = _inputs(3)
    spec = NerfMLPSpec(**SMALL)

    def mine_fn(p, x, v):
        return apply_nerf_mlp(p, spec, positional_encoding(x, 6, 10.0), positional_encoding(v, 2, 1.0))

    def jref(p, x, v):
        return japply(p, JSpec(**SMALL), jencode(x, 6, 10.0), jencode(v, 2, 1.0))

    out, grads = _port_grads(mine_fn, mine, pts, vd, tgt)
    ref_out, ref_grads = _jax_grads(jref, params, pts, vd, tgt)
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
    for a, b in zip(grads, ref_grads):
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("spec_kwargs", [SMALL, dict(), *STUDENTS.values()], ids=["4x64", "8x256", *STUDENTS])
def test_kernel_inputs_match_jax(spec_kwargs):
    params, mine = _trees(spec_kwargs, seed=5)
    ref, ref_meta = jpt._build_kernel_inputs(params, JSpec(**spec_kwargs))
    inputs, meta = ff.build_kernel_inputs(mine, NerfMLPSpec(**spec_kwargs))
    assert list(inputs) == list(ref)
    for k in ref:
        assert inputs[k].dtype == (torch.bfloat16 if k.startswith("w") else torch.float32), k
        np.testing.assert_array_equal(inputs[k].float().numpy(), np.asarray(ref[k], np.float32), err_msg=k)
    assert {k: v for k, v in meta.items()} == {k: v for k, v in ref_meta.items() if k != "dtype"}
    assert ff.grad_names(meta) == jpt._grad_names(ref_meta)
    assert ff.grad_shapes(meta) == jpt._grad_shapes(ref_meta)


# The four network shapes the training field is built for
# (`ops/_build.py::FIELD_SHAPES`), at their full width and frequencies:
# the 2x64@6f/2f proposal net, the stock 8x256@10f/4f net and the two
# students.
LIBRARY_SHAPES = {
    "2x64@6f": dict(depth=2, width=64, input_ch=39, input_ch_views=15, skips=()),
    "8x256@10f": dict(),
    "6x192@10f": dict(depth=6, width=192),
    "4x128@8f": dict(depth=4, width=128, input_ch=51),
}
LAYOUT_CASES = [(name, dict(SMALL, skips=skips), 6, True)  # 4x64
                for name, skips in (("no-skip", (4,)), ("skip2", (1,)))]
LAYOUT_CASES += [(f"{name}-seed{seed}", kw, seed, False) for name, kw in LIBRARY_SHAPES.items() for seed in (0, 1, 2)]
# Each leaf's excess over the strict bound is at most this factor times the
# flipped units' contributions (see the test's docstring).
FLIP_FACTOR = 1.0


def _jax_activations(ref_in, ref_meta, pts, vd, tile=128):
    """The JAX kernels' recomputed activations [N, width] per trunk layer
    and of the view layer, from `_forward_from_refs` jitted on the kernel's
    128-point tiles: the arithmetic the interpret-mode kernel runs (its raw
    output is checked bit-equal)."""
    names, n = list(ref_in), pts.shape[0]
    padded = -(-n // tile) * tile

    @jax.jit
    def forward(p, v, *values):
        inputs = dict(zip(names, values))
        return jpt._forward_from_refs(p, v, lambda k: inputs[k], ref_meta)

    pp, vv = (np.pad(x.T, ((0, 0), (0, padded - n))) for x in (pts, vd))
    tiles = [forward(jnp.asarray(pp[:, t:t + tile]), jnp.asarray(vv[:, t:t + tile]), *ref_in.values())
             for t in range(0, padded, tile)]
    cat = lambda xs: np.concatenate([np.asarray(x.astype(jnp.float32)) for x in xs], 1)[:, :n].T  # noqa: E731
    hs = [cat([a["hs"][i] for a, _ in tiles]) for i in range(ref_meta["n_layers"])]
    return hs, cat([a["hv"] for a, _ in tiles]), cat([raw for _, raw in tiles]).T


def _flip_contribution(inputs, meta, acts, g, jhs, jhv):
    """Sum over the (point, unit) pairs whose ReLU mask differs between the
    two packages' recomputes of |g| * max(1, |h|): g the cotangent that
    reaches the unit before its mask, h the largest input activation of
    its layer at that point, both from the plain version."""
    w = {k: v.float() for k, v in inputs.items()}
    feat, venc, hs, feature, hv = (acts[k] for k in ("feat", "venc", "hs", "feature", "hv"))
    gt = g.T
    zeros = torch.zeros_like(gt)
    g_hv = ff._bf(torch.cat([gt[:, 0:3], zeros[:, :5]], 1)) @ w["w_rgb"]
    h_in = torch.maximum(feature.abs().amax(1), venc.abs().amax(1))
    total = float((g_hv.abs() * torch.clamp(h_in, min=1.0)[:, None] * ((hv > 0) != torch.from_numpy(jhv > 0))).sum())
    g_feature = ff._bf(ff._bf(g_hv * (hv > 0)) @ w["w_view_h"])
    g_h = g_feature @ w["w_feature"] + ff._bf(torch.cat([gt[:, 3:4], zeros[:, :7]], 1)) @ w["w_alpha"]
    for i in range(meta["n_layers"] - 1, -1, -1):
        h_in = (feat if i == 0 else hs[i - 1]).abs().amax(1)
        if i >= 1 and (i - 1) in meta["skips"]:
            h_in = torch.maximum(h_in, feat.abs().amax(1))
        flips = (hs[i] > 0) != torch.from_numpy(jhs[i] > 0)
        total += float((g_h.abs() * torch.clamp(h_in, min=1.0)[:, None] * flips).sum())
        g_c = ff._bf(g_h * (hs[i] > 0))
        if i > 0:
            g_h = g_c @ w[f"w{i}"]
    return total


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_kernel_layout_backward_matches_jax_kernel(case):
    """K5's plain version against the JAX backward kernel on the same
    kernel-layout inputs (both bf16 with fp32 sums, summed in other orders),
    and K4's against the forward kernel, at 4x64 with and without a skip
    and at each of the four library shapes over three init seeds.

    Where both recomputes give every ReLU the same mask, every gradient leaf
    agrees to rel 2e-2. The two sum a pre-activation in other orders, so one
    that lies within fp32 rounding of zero can pass a unit in one package
    and mask it in the other: a flip. The flips are found by comparing each
    package's recomputed activations. A flip of unit j at point p moves the
    leaves by that pair's own terms: the layer's dW row j by g * h_in (g the
    cotangent reaching the unit, h_in the layer's inputs at p), its bias by
    g, and the layers below by the same g carried through one weight row
    (|w| < 1 at these nets). So each leaf's excess over the strict bound is
    held to FLIP_FACTOR (1) times the sum over the flipped pairs of
    |g| * max(1, |h_in|), from the plain version's activations; the 2e-2
    bound itself is not loosened. The two 4x64 cases are held strictly:
    they must have no flip."""
    _, spec_kwargs, seed, strict = case
    params, mine = _trees(spec_kwargs, seed=seed)
    pts, vd, _ = _inputs(4, n=300)  # not a multiple of the 128-point tile
    g = np.random.default_rng(5).normal(size=(8, 300)).astype(np.float32)
    g[4:] = 0.0
    ref_in, ref_meta = jpt._build_kernel_inputs(params, JSpec(**spec_kwargs))
    ref_meta = dict(ref_meta)
    ref_raw = np.asarray(jpt._run_fwd(ref_in, ref_meta, jnp.asarray(pts.T), jnp.asarray(vd.T), 128, True))
    ref = jpt._run_bwd(ref_in, ref_meta, jnp.asarray(pts.T), jnp.asarray(vd.T), jnp.asarray(g), 128, True)
    jhs, jhv, jraw = _jax_activations(ref_in, ref_meta, pts, vd)
    np.testing.assert_array_equal(jraw, ref_raw)  # the recompute is the kernel's arithmetic
    inputs, meta = ff.build_kernel_inputs(mine, NerfMLPSpec(**spec_kwargs))
    pts_t, vd_t = torch.from_numpy(pts.T.copy()), torch.from_numpy(vd.T.copy())
    raw = ff.field_forward(inputs, meta, pts_t, vd_t)
    np.testing.assert_allclose(raw.numpy(), ref_raw, atol=1e-3)
    acts, _ = ff._forward_acts(inputs, meta, pts_t, vd_t)
    n_flips = sum(int(((h > 0) != torch.from_numpy(j > 0)).sum()) for h, j in zip(acts["hs"], jhs))
    n_flips += int(((acts["hv"] > 0) != torch.from_numpy(jhv > 0)).sum())
    if strict:
        assert n_flips == 0
    contribution = _flip_contribution(inputs, meta, acts, torch.from_numpy(g), jhs, jhv) if n_flips else 0.0
    kgrads = ff.field_backward(inputs, meta, pts_t, vd_t, torch.from_numpy(g))
    assert list(kgrads) == jpt._grad_names(ref_meta)
    for name, a in kgrads.items():
        b = np.asarray(ref[name], np.float64)
        assert a.shape == b.shape, name
        err = float(np.abs(a.numpy() - b).max())
        excess = err - 2e-2 * float(np.abs(b).max())
        assert excess <= FLIP_FACTOR * contribution, (name, _rel(a.numpy(), b), n_flips, excess, contribution)


def test_pullback_matches_jax():
    """`grads_to_tree` equals `_grads_to_pytree` on the same kernel-layout
    gradients."""
    spec_kwargs = dict(SMALL, skips=(1,))
    params, mine = _trees(spec_kwargs, seed=7)
    _, meta = ff.build_kernel_inputs(mine, NerfMLPSpec(**spec_kwargs))
    rng = np.random.default_rng(8)
    kgrads = {k: rng.normal(size=s).astype(np.float32) for k, s in ff.grad_shapes(meta).items()}
    _, jmeta = jpt._build_kernel_inputs(params, JSpec(**spec_kwargs))
    ref = jpt._grads_to_pytree({k: jnp.asarray(v) for k, v in kgrads.items()}, params, jmeta)
    mine_tree = ff.grads_to_tree({k: torch.from_numpy(v) for k, v in kgrads.items()}, meta)
    a = tree_leaves(mine_tree)
    b = jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert [g.shape for g in a] == [p.shape for p in tree_leaves(mine)]


@pytest.mark.parametrize("student", STUDENTS)
def test_pullback_matches_jax_at_student_shapes(student):
    """`grads_to_tree` equals `_grads_to_pytree` for each student: the
    6x192@10f skip split at layer 5, the 4x128@8f encoding's 51 of 56 rows."""
    spec_kwargs = STUDENTS[student]
    params, mine = _trees(spec_kwargs, seed=12)
    _, meta = ff.build_kernel_inputs(mine, NerfMLPSpec(**spec_kwargs))
    rng = np.random.default_rng(13)
    kgrads = {k: rng.normal(size=s).astype(np.float32) for k, s in ff.grad_shapes(meta).items()}
    _, jmeta = jpt._build_kernel_inputs(params, JSpec(**spec_kwargs))
    ref = jpt._grads_to_pytree({k: jnp.asarray(v) for k, v in kgrads.items()}, params, jmeta)
    a = tree_leaves(ff.grads_to_tree({k: torch.from_numpy(v) for k, v in kgrads.items()}, meta))
    b = jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert [g.shape for g in a] == [p.shape for p in tree_leaves(mine)]


def test_zero_cotangents_for_points_and_views():
    _, mine = _trees(SMALL, seed=9)
    pts, vd, _ = _inputs(6)
    x = torch.from_numpy(pts).requires_grad_(True)
    v = torch.from_numpy(vd).requires_grad_(True)
    out = ff.fused_field(mine, NerfMLPSpec(**SMALL), x, v)
    dx, dv = torch.autograd.grad(out.sum(), [x, v])
    assert torch.equal(dx, torch.zeros_like(x)) and torch.equal(dv, torch.zeros_like(v))


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers run the plain versions: no kernel launch."""
    _, mine = _trees(SMALL, seed=10)
    pts, vd, _ = _inputs(7, n=64)
    before = dict(ff.LAUNCHES)
    out = ff.fused_field(mine, NerfMLPSpec(**SMALL), torch.from_numpy(pts), torch.from_numpy(vd))
    out.sum().backward()
    assert ff.LAUNCHES == before


def test_fused_field_refuses_other_devices():
    _, mine = _trees(SMALL, seed=11)
    inputs, meta = ff.build_kernel_inputs(mine, NerfMLPSpec(**SMALL))
    x = torch.zeros((3, 8), device="meta")
    with pytest.raises(ValueError, match="no fused field kernel"):
        ff.field_forward(inputs, meta, x, x)
