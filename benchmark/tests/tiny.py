"""Cells of the manifest cut to a size the CPU runs in seconds, for the
tests: the same drivers, files and checks, the program on the CPU."""

from __future__ import annotations

import dataclasses
import json

from benchmark import harness

TINY = {"noise_step_count": 20}
TRAFFIC = {"sample": {"batch": 4, "pool": 8, "warmup_batches": 2},
           "serve": {"batch": 4, "pool": 8, "rate": 12.0, "max_wait_ms": 25.0,
                     "warmup_seconds": 0.5},
           "train": {"batch": 4, "entries": 16, "steps_per_dispatch": 2},
           "train_mesh": {"batch_per_rank": 2, "entries": 16, "ranks": 2, "batches": 2,
                          "warmup_steps": 1, "calibration_steps": 2}}


# cells whose drivers are kept for a later PR but are not in the manifest:
# the mesh cell (not run on four cards yet) and the serving cell (its rate to
# be set again from a new sweep)
KEPT_OUT = {
    "ff32.train.dp4": {"name": "ff32.train.dp4", "config": "pmhc-egnn-ff32",
                       "traffic": "train-dp4-b256", "chips": 4, "why": "data-parallel training"},
    "f32.serve.open": {"name": "f32.serve.open", "config": "pmhc-egnn-f32",
                       "traffic": "serve-open-poisson", "chips": 1, "why": "HTTP serving"},
}


def tiny_cell(name: str) -> harness.Cell:
    manifest = json.load(open(harness.MANIFEST))
    if name in KEPT_OUT:
        manifest["workloads"].append(KEPT_OUT[name])
    cell = harness.load_cell(name, manifest)
    traffic = {**cell.traffic, **TRAFFIC[cell.traffic["driver"]]}
    return dataclasses.replace(cell, config={**cell.config, **TINY}, traffic=traffic)
