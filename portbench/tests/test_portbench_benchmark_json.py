"""BENCHMARK.json keeps to the contract's names, units and keys, and every
name it gives finds its file."""

import json
import re

import pytest

from portbench import harness
from portbench.tests.tiny import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC = {"name", "unit", "better", "bound", "source"}
LAYER = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(ONE_LINE.match(w) for w in bench["command"])
    assert (ROOT / bench["command"][1]).is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in bench[group]]
        assert len(ns) == len(set(ns)), group


def test_configs_and_cells(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/") and (ROOT / c["file"]).is_file()
        assert ONE_LINE.match(c["why"]) and ONE_LINE.match(c["source"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in bench["workloads"]} == {c["name"] for c in bench["configs"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) == LAYER | {"workloads"}, m["name"]
        assert m["moves"] in e2e and ONE_LINE.match(m["layer"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        reported = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_cell_has_its_limits_and_readers(bench):
    for w in bench["workloads"]:
        lim = harness.load_json(HERE / "limits" / f"{w['name']}.json")
        assert lim["limits"] and all(v > 0 for v in lim["limits"].values())
        for m in harness.metrics_of(bench, w["name"], True) + harness.metrics_of(bench, w["name"], False):
            assert callable(harness.metric_reader(m["name"]))
