"""On the card: each cell's compared numbers, at the cell's own size and
load, for the program as configured (within every limit) and for its
control (past at least one limit: the program's own int8 path for frames,
the reference with float8 products for training), on three seeds each.
`python -m pytest benchmark/tests -q -m gpu`."""

import pytest

from harness import control, manifest

MAN = manifest.manifest()
SEEDS = (2**31 + 301, 2**31 + 302, 2**31 + 303)


def _limits(name):
    return manifest.load_cell(name)["check"]["limits"]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_program_within_and_control_past_the_limits(card, name):
    limits = _limits(name)
    for r in control.readings(name, SEEDS, 2.0, control=False):
        assert r.get("errors", 0) == 0
        for k, lim in limits.items():
            assert r["numbers"][k] <= lim, (r["seed"], k, r["numbers"][k], lim)
    for r in control.readings(name, SEEDS, 2.0, control=True):
        assert any(r["numbers"][k] > lim for k, lim in limits.items()), (r["seed"], r["numbers"], limits)
