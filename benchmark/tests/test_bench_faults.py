"""The output check fails the control and each fault a cell can have, with
the rest of a run driven as the benchmark drives it (the program on the CPU,
at a tiny size): the control (the program's bf16 path), half of the batch
left out, an answer altered where it is made, a state left unchanged, the
exchange between cards left out. The limits come from ``benchmark/limits``,
set at the cells' own sizes on the card; at this size the sound runs read
far below them and these runs far above."""

import time

import pytest

from benchmark import faults, harness
from benchmark.tests.tiny import tiny_cell

CASES = [
    ("f32.sample.b64", "bf16", None), ("f32.sample.b64", None, "half_batch"),
    ("f32.sample.b64", None, "altered_answer"), ("f32.sample.b64", None, "unchanged_state"),
    ("f32.serve.open", "bf16", None), ("f32.serve.open", None, "half_batch"),
    ("f32.serve.open", None, "altered_answer"), ("f32.serve.open", None, "unchanged_state"),
    ("ff32.train.b64", "bf16", None), ("ff32.train.b64", None, "half_batch"),
    ("ff32.train.b64", None, "unchanged_state"),
    ("ff32.train.dp4", "bf16", None), ("ff32.train.dp4", None, "no_exchange"),
    ("ff32.train.dp4", None, "half_batch"), ("ff32.train.dp4", None, "unchanged_state"),
]


@pytest.mark.parametrize("name,mode,fault", CASES)
def test_check_fails(name, mode, fault):
    cell = tiny_cell(name)
    kw = {}
    if cell.traffic["driver"] == "train_mesh" and fault:
        kw["prepare"], fault = faults.FAULTS[fault], None
    with faults.planted(fault):
        rec = harness.driver(cell.traffic["driver"]).run(
            cell, seed=2 ** 31 + 29, seconds=1.5, trace=False, t0=time.monotonic(),
            device="cpu", mode=mode, **kw)
    assert not harness.verdict(rec), rec.checks


def test_mesh_program_matches_reference():
    cell = tiny_cell("ff32.train.dp4")
    rec = harness.driver("train_mesh").run(cell, seed=2 ** 31 + 31, seconds=1.0, trace=False,
                                           t0=time.monotonic(), device="cpu")
    assert harness.verdict(rec), rec.checks
    assert rec.forbidden == []
