"""The operation and byte counts against hand counts."""

import pytest

from harness import counts

HIER = {"depth": 8, "width": 256, "skips": [4], "pts_freqs": 10, "view_freqs": 4}
STUDENT = {"depth": 6, "width": 192, "skips": [4], "pts_freqs": 10, "view_freqs": 4}
PROPOSAL = {"depth": 2, "width": 64, "skips": [], "pts_freqs": 6, "view_freqs": 2}


@pytest.mark.parametrize("net, trunk, colour, per_ray", [
    # 63*256 + 6*256*256 + (256+63)*256 + 256 (density head)
    (HIER, 63 * 256 + 6 * 65536 + 319 * 256 + 256, 65536 + 256 * 128 + 128 * 3, 27 * 128),
    # 63*192 + 4*192*192 + (192+63)*192 + 192
    (STUDENT, 63 * 192 + 4 * 36864 + 255 * 192 + 192, 36864 + 192 * 96 + 96 * 3, 27 * 96),
    # 39*64 + 64*64 + 64
    (PROPOSAL, 39 * 64 + 4096 + 64, 4096 + 64 * 32 + 32 * 3, 15 * 32),
])
def test_macs(net, trunk, colour, per_ray):
    assert counts.trunk_macs(net) == trunk
    assert counts.colour_macs(net) == (colour, per_ray)
    assert counts.pass_flops(net, 10, 2, False) == 2 * trunk * 10
    assert counts.pass_flops(net, 10, 2, True) == 2 * ((trunk + colour) * 10 + per_ray * 2)


def test_hier_weight_bytes():
    weights = 63 * 256 + 6 * 65536 + 319 * 256 + 256 + 65536 + 283 * 128 + 128 * 3
    biases = 8 * 256 + 1 + 256 + 128 + 3
    assert counts.weight_bytes(HIER) == 2 * weights + 4 * biases


def test_bound_picks_the_larger():
    t, by = counts.bound_s(989.4e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = counts.bound_s(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
