"""The importance-merge plain version, merged (K2) and importance-only (K6),
against the JAX package's Pallas kernel (interpret mode) and its XLA
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.ops.pallas_sampling import importance_merge_pallas
from nerf_workspaces_explorer_tpu.rays.sampling import merge_sorted_z, sample_pdf
from nerf_workspaces_explorer_tpu_torch.ops.importance_merge import (
    importance_merge,
    importance_merge_plain,
)

torch.set_num_threads(2)


def _inputs(rng, n_samples, n_rays):
    z = np.sort(rng.uniform(0.1, 6.0, size=(n_samples, n_rays)), axis=0).astype(np.float32)
    # Unimodal weights, a Gaussian bump at a per-ray depth (as the JAX
    # package's own kernel test), then edge cases in the first rays.
    centre = rng.uniform(1.0, 5.0, size=(1, n_rays))
    w = (np.exp(-0.5 * ((z - centre) / 0.4) ** 2) + 1e-4).astype(np.float32)
    w[:, 0] = 0.0  # all-zero weights: the uniform pdf of the +1e-5 guard
    w[:, 1] = 0.0
    w[-2, 1] = 50.0  # all mass in the last interior bin: u >= cdf[-1] clamps
    w[10:40, 2] = 0.0  # a flat CDF stretch (tied entries up to the guard)
    return w, z


def _tied_inputs(rng, n_samples, n_rays):
    """Exact CDF ties: two interior weights of 2**20 per ray (the +1e-5 guard
    vanishes next to them in fp32) and zeros between, so the CDF is exactly
    [~0 .. 0.5, 0.5, .., 0.5, 1.0, .., 1.0] and the quantiles u = 0.5 and
    u = 1 land on tied entries. The `cdf_b <= u` rule takes the last tie;
    a `<` rule would land one or more bins earlier."""
    z = np.sort(rng.uniform(0.1, 6.0, size=(n_samples, n_rays)), axis=0).astype(np.float32)
    w = np.zeros((n_samples, n_rays), np.float32)
    a = rng.integers(1, n_samples - 3, size=n_rays)
    b = a + 2 + rng.integers(0, n_samples - 3 - a)  # a + 2 <= b <= S - 2
    w[a, np.arange(n_rays)] = 2.0**20
    w[b, np.arange(n_rays)] = 2.0**20
    return w, z


def _xla_reference(w, z, n_importance):
    zr, wr = jnp.asarray(z.T), jnp.asarray(w.T)
    samples = sample_pdf(0.5 * (zr[:, 1:] + zr[:, :-1]), wr[:, 1:-1], n_importance, deterministic=True)
    return np.asarray(merge_sorted_z(zr, samples)).T


def assert_merge_close(mine, ref, z):
    """Equal up to the fp32 summation order of the CDF. A quantile on a CDF
    edge can resolve to the neighbouring interval under another order: the
    JAX package's contract allows such flips on < 0.5% of samples, each
    bounded by one coarse bin (tests/test_pallas.py:463-470).

    The u = 1 quantile is the one exception. When the last bin's pdf is
    under the 1e-5 guard (a far-end weight near zero, as on most rays that
    hit a surface), u = 1 resolves to one end of that bin if cdf[-1] rounds
    to <= 1 and to the other end if it rounds above, which moves it past the
    coarse depth z[S-2]: merged rows -3 and -2 change. On these inputs every
    flip lies in those two rows (0.15-0.68% of all depths under numpy seeds
    0-2, none elsewhere), so they get the one-bin bound only and the rest
    keep the 0.5% budget."""
    assert mine.shape == ref.shape
    err = np.abs(mine - ref)
    flips = float(np.mean(np.delete(err, [-3, -2], axis=0) > 1e-4))
    assert flips < 5e-3, f"boundary flips on {flips:.2%} of depths outside the u = 1 rows"
    assert err.max() <= float(np.max(np.diff(z, axis=0))) + 1e-4
    assert np.all(np.diff(mine, axis=0) >= 0)


def test_matches_pallas_kernel(rng):
    """At the main path's 64 + 128 samples. (The Pallas kernel interpolates
    in slope/intercept form, which loses ~1e-3 in near-degenerate bins; the
    XLA reference below is the precise one.)"""
    n_samples, n_importance = 64, 128
    w, z = _inputs(rng, n_samples, 128)
    ref = np.asarray(
        importance_merge_pallas(jnp.asarray(w), jnp.asarray(z), n_importance, ray_tile=128, interpret=True)
    )
    mine = importance_merge(torch.from_numpy(w), torch.from_numpy(z), n_importance).numpy()
    assert mine.shape == (n_samples + n_importance, 128)
    assert_merge_close(mine, ref, z)


@pytest.mark.parametrize("n_samples,n_importance", [(64, 128), (16, 16), (8, 2)])
def test_matches_xla_reference(rng, n_samples, n_importance):
    w, z = _inputs(rng, n_samples, 37)  # a ray count no TPU tile divides
    mine = importance_merge_plain(torch.from_numpy(w), torch.from_numpy(z), n_importance).numpy()
    assert_merge_close(mine, _xla_reference(w, z, n_importance), z)


def test_uniform_weights_exact():
    """A strictly increasing CDF has no degenerate interval: the plain
    version and the XLA path agree to fp32 rounding of the depths
    (tests/test_pallas.py:473)."""
    s, r, n_imp = 32, 128, 64
    z = np.broadcast_to(np.linspace(0.5, 8.0, s, dtype=np.float32)[:, None], (s, r)).copy()
    w = np.ones((s, r), np.float32)
    mine = importance_merge(torch.from_numpy(w), torch.from_numpy(z), n_imp).numpy()
    np.testing.assert_allclose(mine, _xla_reference(w, z, n_imp), rtol=0, atol=1e-5)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_exact_cdf_ties_take_the_last_tie(rng, reference):
    w, z = _tied_inputs(rng, 16, 128)
    if reference == "xla":
        ref = _xla_reference(w, z, 5)
    else:
        ref = np.asarray(importance_merge_pallas(jnp.asarray(w), jnp.asarray(z), 5, ray_tile=128, interpret=True))
    mine = importance_merge(torch.from_numpy(w), torch.from_numpy(z), 5).numpy()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5)


def test_coarse_depths_survive_the_merge(rng):
    w, z = _inputs(rng, 16, 20)
    mine = importance_merge(torch.from_numpy(w), torch.from_numpy(z), 8).numpy()
    for r in range(20):
        assert np.isin(z[:, r], mine[:, r]).all()


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="one \\[S, R\\] shape"):
        importance_merge(torch.zeros(8, 4), torch.zeros(8, 5), 4)


def assert_importance_only_close(mine, ref, z):
    """tests/test_pallas.py:572's rule for merge=False: ascending, flips on
    < 0.5% of samples, each within one coarse bin."""
    assert mine.shape == ref.shape
    assert np.all(np.diff(mine, axis=0) >= -1e-6)
    err = np.abs(mine - ref)
    flips = float(np.mean(err > 1e-4))
    assert flips < 5e-3, f"boundary flips on {flips:.2%} of samples"
    assert err.max() <= float(np.max(np.diff(z, axis=0))) + 1e-4


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_importance_only_matches_jax(rng, reference):
    """merge=False: the I ascending samples alone, against
    `importance_merge_pallas(merge=False, interpret=True)` and against
    JAX's `sample_pdf`, at tests/test_pallas.py:572's 64 samples, 96
    quantiles and 256 rays."""
    s, r, n_imp = 64, 256, 96
    w, z = _inputs(rng, s, r)
    if reference == "pallas":
        ref = np.asarray(importance_merge_pallas(
            jnp.asarray(w), jnp.asarray(z), n_imp, ray_tile=128, interpret=True, merge=False))
    else:
        zr, wr = jnp.asarray(z.T), jnp.asarray(w.T)
        ref = np.asarray(sample_pdf(0.5 * (zr[:, 1:] + zr[:, :-1]), wr[:, 1:-1], n_imp, deterministic=True)).T
    mine = importance_merge(torch.from_numpy(w), torch.from_numpy(z), n_imp, merge=False).numpy()
    assert mine.shape == (n_imp, r)
    assert_importance_only_close(mine, ref, z)


def test_importance_only_is_the_merge_without_coarse_depths(rng):
    """Removing the coarse depths from the merged rows leaves the
    importance-only rows (ties aside)."""
    w, z = _inputs(rng, 16, 24)
    merged = importance_merge(torch.from_numpy(w), torch.from_numpy(z), 12).numpy()
    alone = importance_merge(torch.from_numpy(w), torch.from_numpy(z), 12, merge=False).numpy()
    for r in range(24):
        rest = list(merged[:, r])
        for depth in z[:, r]:
            rest.remove(depth)
        np.testing.assert_array_equal(np.sort(rest), alone[:, r])


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "only"])
def test_turbo_shapes_match_pallas_kernel(rng, merge):
    """At the turbo preset's placement shapes (64 proposal samples, 48
    importance samples), merged and importance-only, against
    `importance_merge_pallas` in interpret mode. At 48 quantiles the u = 1
    row is 2.1% of the importance-only samples, and every flip lies there
    (merged: rows -3 and -2, as in `assert_merge_close`; 1.0-1.2% of the
    samples under numpy seeds 0-2): that row gets its ray's last bin as its
    bound, the other rows keep the 0.5% budget."""
    s, r, n_imp = 64, 128, 48
    w, z = _inputs(rng, s, r)
    ref = np.asarray(importance_merge_pallas(
        jnp.asarray(w), jnp.asarray(z), n_imp, ray_tile=128, interpret=True, merge=merge))
    mine = importance_merge(torch.from_numpy(w), torch.from_numpy(z), n_imp, merge=merge).numpy()
    assert mine.shape == ((s + n_imp) if merge else n_imp, r)
    if merge:
        assert_merge_close(mine, ref, z)
        return
    assert_importance_only_close(mine[:-1], ref[:-1], z)
    mid = 0.5 * (z[1:] + z[:-1])
    assert np.all(np.abs(mine[-1] - ref[-1]) <= mid[-1] - mid[-2] + 1e-4)
    assert np.all(mine[-1] >= mine[-2])
