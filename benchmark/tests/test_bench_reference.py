"""The plain reference against the system's plain CPU path at a tiny size:
each cell's driver drives the program on the CPU and the check finds it
correct, with its numbers far inside their limits."""

import time

import pytest

from benchmark import harness
from benchmark.reference import atoms
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_cell


def test_weights_are_the_published_tensors():
    from pmhc_tpu_torch.models import ScoreNetwork

    w = ref.make_weights(2 ** 31 + 3, "cpu")
    mine = ScoreNetwork().state_dict()
    assert {k: tuple(v.shape) for k, v in w.items()} == {k: tuple(v.shape) for k, v in mine.items()}
    assert sum(v.numel() for v in w.values()) == 79195
    again = ref.make_weights(2 ** 31 + 3, "cpu")
    assert all((w[k] == again[k]).all() for k in w)


def test_pdb_reader_round_trip():
    import numpy as np

    from pmhc_tpu_torch.io.pdb import pdb_bytes, precompute_pdb_arrays  # noqa: F401

    got = atoms.read_pdb(b"ATOM      1  N   ALA P   1     -1.234   5.678  -9.012  1.00  0.00"
                         b"           N  \nEND\n")
    assert got["P"][0][:3] == ("N", "ALA", 1)
    np.testing.assert_allclose(got["P"][0][3], [-1.234, 5.678, -9.012])


@pytest.mark.parametrize("name", ["f32.sample.b64", "ff32.train.b64", "f32.serve.open"])
def test_program_matches_reference(name):
    cell = tiny_cell(name)
    rec = harness.driver(cell.traffic["driver"]).run(
        cell, seed=2 ** 31 + 11, seconds=1.5, trace=False, t0=time.monotonic(), device="cpu")
    assert harness.verdict(rec), rec.checks
    assert rec.completed > 0 and rec.failed == 0
    for k, v in rec.checks.items():
        assert v <= cell.limits[k] / 3, (k, v)
