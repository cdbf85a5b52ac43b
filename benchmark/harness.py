"""What every cell shares: the manifest and the files it names, the run's
record, and the result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. Everything of one configuration, mix, driver or metric sits in
files of its own, found by name, so a new cell is new files and new entries
and edits neither. Its files, under ``benchmark/``:

- ``configs/<config>.json``: the network's sizes and the mode it runs in,
  with the ``reduced`` list of its manifest entry (the keys cut from the
  source; may be empty);
- ``traffic/<traffic>.json``: the mix's parameters, naming its ``driver``;
- ``drivers/<driver>.py``: ``run(cell, seed, seconds, trace, t0, ...)``, which
  returns a ``Record``, and ``TINY_TRAFFIC``, the mix's sizes cut to what the
  CPU tests run (``tests/tiny.py``); a driver may be shared by many mixes;
- ``limits/<config>.<driver>.json``: the limits of the numbers the driver's
  check compares;
- ``metrics/<metric>.py``: ``read(record)``, the metric from the run's
  ``Record``, ``None`` where there is nothing to read;
- a reference package ``reference*/`` where the driver checks a network the
  existing references do not compute.

Its entries in ``BENCHMARK.json``: the configuration (``configs``), the cell
(``workloads``), the cell's name appended to the ``workloads`` of each
end-to-end metric it reports (``setup_s`` covers every cell), and a
``per_layer`` entry for each new reader, or the cell's name appended to an
existing one's ``workloads``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "pmhc_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    m = _json(MANIFEST) if manifest is None else manifest
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(ROOT, conf["file"]))
    check_reduced(conf, config)
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(HERE, "limits", f"{w['config']}.{traffic['driver']}.json"))
    mine = lambda ms: [x for x in ms if name in x.get("workloads", [name])]  # noqa: E731
    return Cell(name, int(w["chips"]), config, traffic, limits["limits"],
                mine(m["end_to_end"]), mine(m["per_layer"]))


def check_reduced(entry: dict, config: dict) -> None:
    """A configuration's ``reduced``: a list of the keys cut from its source,
    each at most 200 characters, the same in its manifest entry and in its
    file."""
    cut = entry["reduced"]
    if not (isinstance(cut, list) and all(isinstance(k, str) and 0 < len(k) <= 200
                                          for k in cut)):
        raise ValueError(f"{entry['name']}: reduced must be a list of short strings: {cut!r}")
    if config.get("reduced") != cut:
        raise ValueError(f"{entry['name']}: reduced is {cut!r} in BENCHMARK.json and "
                         f"{config.get('reduced')!r} in {entry['file']}")


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    completed: int = 0          # samples, requests or examples done in the window
    latencies: List[float] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Any = None           # trace.Trace of the traced span (the first card's)
    card_traces: List[Any] = field(default_factory=list)  # every card's, on a mesh
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    cards: int = 1
    # modules of JAX or the JAX package loaded in processes the driver started
    forbidden: List[str] = field(default_factory=list)


def read_metric(name: str, record: Record):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def verdict(record: Record) -> bool:
    """Every compared number within its limit, and nothing failed."""
    lim = record.cell.limits
    return record.failed == 0 and all(
        name in record.checks and record.checks[name] <= limit for name, limit in lim.items())


def checks_line(record: Record) -> Dict[str, Dict[str, float]]:
    return {name: {"value": record.checks.get(name, float("inf")), "limit": limit}
            for name, limit in record.cell.limits.items()}


def forbidden_modules(modules) -> List[str]:
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
