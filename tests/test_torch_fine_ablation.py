"""The fine-pass ablation's plain version (K8) against the JAX package's
`scripts/profile_fine_ablation.py::run_ablation`, its Pallas kernel run in
interpret mode, on the 4x128@8f student the script profiles."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nerf_workspaces_explorer_tpu.ops import pallas_render as jpr
from nerf_workspaces_explorer_tpu.ops import quantize as jq
from nerf_workspaces_explorer_tpu.train.distill import load_turbo_checkpoint as jload_turbo
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import params_from_numpy
from nerf_workspaces_explorer_tpu_torch.ops import fine_ablation as fa
from nerf_workspaces_explorer_tpu_torch.ops import fused_render as fr
from nerf_workspaces_explorer_tpu_torch.ops import quantize as q
from nerf_workspaces_explorer_tpu_torch.train.distill import load_turbo_checkpoint as pload_turbo

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDECAR = os.path.join(ROOT, "assets", "bench", "synth_proposal.turbo.npz")
N_RAYS, N_SAMPLES, SPS = 256, 8, 4


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "profile_fine_ablation", os.path.join(ROOT, "scripts", "profile_fine_ablation.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)).copy()).to(dtype)


def _port_net():
    params, _ = pload_turbo(SIDECAR)
    return params_from_numpy(params["fine"])


@pytest.fixture(scope="module")
def setup():
    """Both packages' int8 kernel params of the student's fine net (int8
    trunk and heads, as the script calibrates it) and seeded inputs."""
    params, _ = jload_turbo(SIDECAR)
    net = params["fine"]
    spec = jq.spec_from_net_params(net)
    kpj = jpr.prepare_kernel_params(net, spec, quant=jq.calibrate_trunk(net, spec, heads=True))
    tree = _port_net()
    pspec = q.spec_from_net_params(tree)
    kp = fr.prepare_kernel_params(tree, pspec, quant=q.calibrate_trunk(tree, pspec, heads=True))
    rng = np.random.default_rng(0)
    o = rng.normal(scale=0.5, size=(N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, size=(N_SAMPLES, N_RAYS)), axis=0).astype(np.float32)
    o_ph, d_ph = jpr.ray_phase_vectors(jnp.asarray(o), jnp.asarray(d), kpj.pts_freqs)
    dists = jpr._dists_from_z(jnp.asarray(z), jnp.linalg.norm(jnp.asarray(d), axis=-1)[None])
    venc = jpr.encode_viewdirs_kernel_order(jnp.asarray(v), num_freqs=kpj.view_freqs)
    jax_args = (o_ph, d_ph, jnp.asarray(z), dists, venc)
    port_args = (_t(o_ph), _t(d_ph), _t(z), _t(dists), _t(venc, torch.bfloat16))
    return kp, kpj, jax_args, port_args


SCRIPT_MODES = [(), ("enc",), ("enc-direct",), ("enc-nobase",), ("enc-noconcat",), ("enc-postq",),
                ("enc-stack",), ("enc-duo",), ("heads",), ("epilogue",), ("enc", "heads", "epilogue")]


@pytest.mark.parametrize("ablate", SCRIPT_MODES, ids=lambda a: "+".join(a) or "full")
def test_ablation_plain_matches_jax_kernel(setup, ablate):
    """Every flag set of the ablation script (and no flag, heads, epilogue,
    trunk-only) against the unchanged TPU kernel in interpret mode
    (256 rays, 8 samples, samples_per_step 4, ray tile 128). Rows 1, 2, 6, 7
    stay 0 and row 5 (T) matches. rgb: at least 98% of the rays exact to
    1e-6, as in tests/test_torch_int8_render.py (the interpreted kernel runs
    under jit, where XLA contracts the fp32 encoding chains into FMAs, so an
    int8 feature level can round the other way), relative to the largest
    value where the sums are not colours: "heads" sums raw int8 activations
    (up to ~30 here, where the TPU kernel's fused multiply-adds move the
    last bit, 1.9e-6), "epilogue" raw accumulators (1e5). Every ray within
    2e-3 of the colours, or 2e-2 of the raw scale, where a flipped level
    shows at full size (trunk-only: 4 of 448)."""
    kp, kpj, jax_args, port_args = setup
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_jax_script().run_ablation(kpj, *jax_args, frozenset(ablate), samples_per_step=SPS,
                                                    ray_tile=128))
    mine = fa.run_ablation(kp, *port_args, frozenset(ablate), samples_per_step=SPS).numpy()
    assert mine.shape == ref.shape == (8, N_RAYS) and np.isfinite(mine).all()
    assert not mine[[3, 4, 6, 7]].any() and not ref[[3, 4, 6, 7]].any()
    raw = "heads" in ablate or "epilogue" in ablate
    scale = max(1.0, float(np.abs(ref[0:3]).max())) if raw else 1.0
    err = np.abs(mine[[0, 1, 2, 5]] - ref[[0, 1, 2, 5]]) / scale
    assert (err.max(0) <= 1e-6).mean() >= 0.98, (err.max(0) <= 1e-6).mean()
    assert err.max() <= (2e-2 if raw else 2e-3), err.max()


def test_ablation_without_flags_is_the_int8_full_pass(setup):
    """No flag: the int8 full pass's rgb and final transmittance, composited
    one sample at a time instead of in one sum (to 1e-6)."""
    kp, _, _, args = setup
    mine = fa.run_ablation(kp, *args, frozenset())
    full = fr.nerf_render(kp, *args)
    assert torch.allclose(mine[[0, 1, 2, 5]], full[[0, 1, 2, 5]], rtol=0, atol=1e-6)


def test_ablation_modes_and_refusals(setup):
    """Layout-only flags are the full pass on this card; launches count by
    mode on the card only; unknown flags and bf16 params are refused."""
    kp, _, _, args = setup
    full = fa.run_ablation(kp, *args, frozenset())
    for flag in ("enc-postq", "enc-stack", "enc-duo"):
        assert torch.equal(fa.run_ablation(kp, *args, {flag}), full)
    assert fa.mode_name({"epilogue", "enc", "heads"}) == "enc+heads+epilogue"
    assert set(fa.LAUNCHES) == set(fa.MODES) and not any(fa.LAUNCHES.values())
    with pytest.raises(ValueError, match="unknown ablation flags"):
        fa.run_ablation(kp, *args, {"trunk"})
    with pytest.raises(ValueError, match="built for the modes"):
        fa.run_ablation(kp, *args, {"enc", "heads"})
    tree = _port_net()
    bf16 = fr.prepare_kernel_params(tree, q.spec_from_net_params(tree))
    with pytest.raises(ValueError, match="int8"):
        fa.run_ablation_plain(bf16, *args, frozenset())
    with pytest.raises(ValueError, match="no ablation kernel"):
        fa.run_ablation(kp, *(a.to("meta") for a in args), frozenset())

