"""The generators: the same seed gives the same requests, another seed
another order of the same work."""

from harness import manifest


def _reqs(traffic, seed):
    mix = manifest.load_traffic(traffic)
    return manifest.generator(mix["kind"]).requests(mix, seed)


def _key(req):
    return tuple(sorted((k, v.tobytes() if hasattr(v, "tobytes") else v) for k, v in req.items()))


def test_clicks_are_deterministic_and_seeded():
    a, b, c = _reqs("click-320", 7), _reqs("click-320", 7), _reqs("click-320", 2**31 + 11)
    assert [_key(r) for r in a] == [_key(r) for r in b]
    assert [_key(r) for r in a] != [_key(r) for r in c]
    # the same pool of clicks in another order
    assert sorted(map(_key, a)) == sorted(map(_key, c))
    offices = manifest.load_traffic("click-320")["offices"]
    assert [r["office"] for r in a[: len(offices)]] == offices


def test_clicks_keep_to_the_mix():
    mix = manifest.load_traffic("click-320")
    for r in _reqs("click-320", 3):
        (x0, x1), (y0, y1) = mix["rel"][r["office"]]
        assert x0 <= r["rel_x"] <= x1 and y0 <= r["rel_y"] <= y1
        assert r["hor"] % mix["hor_step"] == 0 and r["ver"] in mix["ver_angles"]


def test_walk_is_deterministic_and_seeded():
    a, b, c = _reqs("walk-320", 7), _reqs("walk-320", 7), _reqs("walk-320", 2**31 + 11)
    assert [r["index"] for r in a] == [r["index"] for r in b]
    assert a[0]["index"] != c[0]["index"]
    assert sorted(r["index"] for r in a) == sorted(r["index"] for r in c) == list(range(len(a)))
    n = len(a)
    assert all(a[k + 1]["index"] == (a[k]["index"] + 1) % n for k in range(n - 1))
