"""What every cell shares: the manifest and the files it names, the run's
record, and the result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. ``configs/<config>.json`` holds the network's sizes and the mode
it runs in; ``traffic/<traffic>.json`` holds the mix's parameters and names
the driver (``drivers/<driver>.py``) that runs it; ``limits/<config>.<driver>.json``
holds the limits of the numbers that driver's check compares. Each metric is
read from the run's ``Record`` by ``metrics/<metric>.py`` (``read(record)``,
``None`` where there is nothing to read). Adding a cell or a metric adds
files and entries; it edits none.
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
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(HERE, "limits", f"{w['config']}.{traffic['driver']}.json"))
    mine = lambda ms: [x for x in ms if name in x.get("workloads", [name])]  # noqa: E731
    return Cell(name, int(w["chips"]), config, traffic, limits["limits"],
                mine(m["end_to_end"]), mine(m["per_layer"]))


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
    trace: Any = None           # trace.Trace of the traced span
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    cards: int = 1


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
