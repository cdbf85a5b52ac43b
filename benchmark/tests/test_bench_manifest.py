"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each entry names, and that every metric's cells report the end-to-end
metric it moves."""

import copy
import glob
import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import KEPT_OUT, tiny_cell

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
        assert TEXT.match(c["source"])
        assert any(w["config"] == c["name"] for w in M["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(CELLS) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and TEXT.match(w["why"]) and NAME.match(w["traffic"])
        cell = harness.load_cell(w["name"])
        assert os.path.isfile(os.path.join(harness.HERE, "drivers", f"{cell.traffic['driver']}.py"))
        assert callable(getattr(harness.driver(cell.traffic["driver"]), "run", None))
        assert cell.limits


TRAFFIC = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(harness.HERE, "traffic", "*.json")))


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_every_traffic_names_a_driver_with_tiny_sizes(traffic):
    """Each mix (kept-out ones too) names ``drivers/<driver>.py``, which defines
    ``run`` and the mix's CPU sizes; each cell of it, in the manifest or kept
    out, cuts to them."""
    with open(os.path.join(harness.HERE, "traffic", f"{traffic}.json")) as f:
        mix = json.load(f)
    assert NAME.match(mix["driver"]), traffic
    assert os.path.isfile(os.path.join(harness.HERE, "drivers", f"{mix['driver']}.py")), traffic
    drv = harness.driver(mix["driver"])
    assert callable(getattr(drv, "run", None)), mix["driver"]
    assert isinstance(getattr(drv, "TINY_TRAFFIC", None), dict), mix["driver"]
    cells = [w["name"] for w in M["workloads"] + list(KEPT_OUT.values())
             if w["traffic"] == traffic]
    for name in cells:
        cell = tiny_cell(name)
        assert cell.traffic == {**mix, **drv.TINY_TRAFFIC} and cell.limits, name


def _with_config(tmp_path, reduced_entry, reduced_file, cell="ff32.train.b64"):
    """The manifest with ``cell``'s configuration moved to a file of its own
    under ``tmp_path``."""
    m = copy.deepcopy(M)
    conf = next(c for c in m["configs"] if c["name"] == CELLS[cell]["config"])
    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        config = json.load(f)
    config["reduced"] = reduced_file
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    conf.update(file=str(path), reduced=reduced_entry)
    return m


@pytest.mark.parametrize("reduced", [[], ["layers"], ["layers", "max_len", "pocket_len"],
                                     ["num_hidden_layers", "x" * 200]])
def test_reduced_may_list_cuts(tmp_path, reduced):
    cell = harness.load_cell("ff32.train.b64", _with_config(tmp_path, reduced, reduced))
    assert cell.config["reduced"] == reduced


@pytest.mark.parametrize("entry,file", [
    (["x" * 201], ["x" * 201]),                 # longer than 200 characters
    ([""], [""]),
    (["layers", 3], ["layers", 3]),             # not a list of strings
    ("layers", "layers"),
    (["layers"], []),                           # the file and the entry differ
    ([], ["layers"]),
    (["layers"], None),
])
def test_reduced_refused(tmp_path, entry, file):
    with pytest.raises(ValueError):
        harness.load_cell("ff32.train.b64", _with_config(tmp_path, entry, file))


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
