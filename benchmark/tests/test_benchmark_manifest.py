"""BENCHMARK.json loads, keeps the contract's character sets, and names
files that exist: one a configuration, a mix, a cell and a metric."""

import json
import os
import re

from harness import manifest

MAN = manifest.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"] and MAN["command"][1] == "benchmark/run.py"
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["traffic"] for w in MAN["workloads"]] + [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert manifest.NAME_RE.match(n), n
    assert len(set(names[: len(MAN["configs"]) + len(MAN["workloads"])])) == len(MAN["configs"]) + len(MAN["workloads"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert manifest.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in MAN["workloads"]] + [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_name_finds_its_file():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        cfg = manifest.load_config(MAN, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(manifest.ROOT, cfg["serve"]["checkpoint"]))
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        mix = manifest.load_traffic(w["traffic"])
        assert os.path.exists(os.path.join(manifest.BENCH_DIR, "generators", f"{mix['kind']}.py"))
        assert set(manifest.load_cell(w["name"])) >= {"check", "trace"}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(MAN, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(MAN, "per_layer", w["name"])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(MAN)) < 64 * 1024


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^\w+_roofline(\.\w+)?$", m["name"]) and m["unit"] == "%"


def test_every_per_layer_metric_lists_its_cells_and_they_report_what_it_moves():
    for m in MAN["per_layer"]:
        assert m["workloads"], m
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in manifest.metrics_of(MAN, "end_to_end", w)], (m, w)
