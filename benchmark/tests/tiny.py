"""Cells cut to a size the CPU runs in seconds, for the tests: the same
drivers, files and checks, the program on the CPU.

A cell's traffic takes its driver's ``TINY_TRAFFIC`` over the mix's own
values, and its configuration the ``TINY`` values below. A new driver
brings its tiny sizes beside it, so a new cell needs no edit here.
"""

from __future__ import annotations

import dataclasses
import json

from benchmark import harness

TINY = {"noise_step_count": 20}


# cells whose drivers are kept for a later PR but are not in the manifest:
# the serving cell (its rate to be set again from a new sweep)
KEPT_OUT = {
    "f32.serve.open": {"name": "f32.serve.open", "config": "pmhc-egnn-f32",
                       "traffic": "serve-open-poisson", "chips": 1, "why": "HTTP serving"},
}


def tiny_cell(name: str) -> harness.Cell:
    manifest = json.load(open(harness.MANIFEST))
    if name in KEPT_OUT:
        manifest["workloads"].append(KEPT_OUT[name])
    cell = harness.load_cell(name, manifest)
    tiny = harness.driver(cell.traffic["driver"]).TINY_TRAFFIC
    return dataclasses.replace(cell, config={**cell.config, **TINY},
                               traffic={**cell.traffic, **tiny})
