"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each entry names, and that every metric's cells report the end-to-end
metric it moves."""

import json
import os
import re

import pytest

from benchmark import harness

M = json.load(open(harness.MANIFEST))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = {w["name"]: w for w in M["workloads"]}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(
        re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_their_keys_and_names(section, keys):
    entries = M[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["name"]
            assert e["better"] in ("lower", "higher")


def test_metrics_sources_and_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_configs_and_cells():
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
        assert TEXT.match(c["source"]) and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in M["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(CELLS) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and TEXT.match(w["why"]) and NAME.match(w["traffic"])
        cell = harness.load_cell(w["name"])
        assert cell.traffic["driver"] in ("sample", "serve", "train", "train_mesh")
        assert cell.limits


def _reports(cell, metric):
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    e2e = {x["name"]: x for x in M["end_to_end"]}
    assert m["moves"] in e2e
    assert os.path.isfile(os.path.join(harness.HERE, "metrics", f"{metric}.py"))
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS and _reports(cell, e2e[m["moves"]]), (metric, cell)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in M["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(cell, m) for m in M["per_layer"])
    for name in e2e:
        assert os.path.isfile(os.path.join(harness.HERE, "metrics", f"{name}.py"))


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(TEXT.match(x) for x in layers)
