"""The int4 probe's plain legs (K9) against the JAX package's
`scripts/probe_int4_tpu.py`, its Pallas legs run in interpret mode on the
same numpy-seeded inputs."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nerf_workspaces_explorer_tpu_torch.ops import int4_probe as ip

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("packed", [False, True], ids=["int4-operand", "int4x2-packed-bytes"])
def test_plain_legs_match_jax_legs(packed):
    """Each JAX leg draws its int4 matrix and b from numpy's global generator
    and returns its relative error against numpy (~4e-8 and ~7e-8 in
    interpret mode); the port's plain leg on the same draws is held to 1e-6
    relative, as is JAX's own."""
    tpu = _script("probe_int4_tpu")
    jax_leg = tpu._leg_packed_bytes if packed else tpu._leg_int4_operand
    port = _script("probe_int4_torch")
    np.random.seed(7)
    with pltpu.force_tpu_interpret_mode():
        jax_err = jax_leg()
    np.random.seed(7)
    a, b, ref = port.leg_inputs(packed, torch.device("cpu"))
    assert a.dtype == (torch.uint8 if packed else torch.int8) and a.shape == ((64 if packed else 128), 128)
    out = ip.int4_matmul(a, b, packed=packed)
    assert out.dtype == torch.float32 and out.shape == (128, 128)
    assert port.rel_err(out, ref) <= 1e-6
    assert jax_err <= 1e-6


def test_packing_round_trip_and_refusals():
    """Nibble packing as the TPU probe packs (low nibble = even row), undone
    by sign-extending shifts; the plain legs agree; bad operands raise."""
    g = torch.Generator().manual_seed(0)
    w4 = torch.randint(-8, 8, (32, 48), generator=g, dtype=torch.int8)
    packed = ip.pack_int4_rows(w4)
    ref = ((w4[0::2].numpy() & 0xF) | ((w4[1::2].numpy() & 0xF) << 4)).astype(np.uint8)
    np.testing.assert_array_equal(packed.numpy(), ref)
    assert torch.equal(ip.unpack_int4_rows(packed), w4)
    b = torch.randn(48, 16, generator=g).to(torch.bfloat16)
    assert torch.equal(ip.int4_matmul(packed, b, packed=True), ip.int4_matmul(w4, b))
    with pytest.raises(ValueError, match="bfloat16"):
        ip.int4_matmul(w4, b.float())
    with pytest.raises(ValueError, match="no int4 kernel"):
        ip.int4_matmul(w4.to("meta"), b.to("meta"))
    assert not any(ip.LAUNCHES.values())


def test_probe_script_on_the_cpu(capsys):
    """The script's verdicts through the plain legs (`--device cpu`)."""
    assert _script("probe_int4_torch").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("[int4-operand] OK") and out[2].startswith("[int4x2-packed-bytes] OK")
    assert out[-1] == "INT4 VIABLE"
