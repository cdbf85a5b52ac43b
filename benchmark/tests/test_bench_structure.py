"""The structure network's cell (``ipa-f32.sample.b64``) at a tiny size on
the CPU: its driver drives the program and the reference finds it correct,
far inside the limits; the bf16 control and each fault fail the check;
its weights are the network's tensors; its readers on synthetic records;
its FLOP count against torch's counter on the reference."""

import time

import pytest
import torch

from benchmark import faults, harness, roofline, roofline_structure
from benchmark.reference_structure import model as ref
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import Trace

torch.set_num_threads(1)
CELL = "ipa-f32.sample.b64"


def _run(mode=None, fault=None, seed=2 ** 31 + 23):
    cell = tiny_cell(CELL)
    with faults.planted(fault):
        rec = harness.driver(cell.traffic["driver"]).run(
            cell, seed=seed, seconds=1.0, trace=False, t0=time.monotonic(), device="cpu",
            mode=mode)
    return cell, rec


def test_program_matches_reference():
    cell, rec = _run()
    assert harness.verdict(rec), rec.checks
    assert rec.completed > 0 and rec.failed == 0
    for k, v in rec.checks.items():
        assert v <= cell.limits[k] / 10, (k, v)


@pytest.mark.parametrize("mode,fault", [("bf16", None), (None, "half_batch"),
                                        (None, "altered_answer"), (None, "unchanged_state")])
def test_check_fails(mode, fault):
    _, rec = _run(mode, fault)
    assert not harness.verdict(rec), rec.checks


def test_weights_are_the_networks_tensors():
    from pmhc_tpu_torch.models.structure import StructureNetwork

    w = ref.make_weights(2 ** 31 + 3, "cpu")
    mine = StructureNetwork().state_dict()
    assert {k: tuple(v.shape) for k, v in w.items()} == {k: tuple(v.shape) for k, v in mine.items()}
    assert sum(v.numel() for v in w.values()) == 2_037_932
    again = ref.make_weights(2 ** 31 + 3, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def _record(**kw):
    r = harness.Record(harness.load_cell(CELL))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_readers():
    B, L = 64, 96
    bound = roofline_structure.ipa_attention_bound_s(B, L)
    # 2 steps: 16 launches at twice their bound, GEMMs of 1 ms, 3 ms else
    ks = [("ipa_attention_kernel", 1e6 * 2 * bound * i, 1e6 * 2 * bound * (i + 1))
          for i in range(16)]
    ks += [("sm90_xmma_gemm_f32f32_tn", 0, 1000.0), ("void gemv2T_kernel", 0, 1000.0),
           ("elementwise_kernel", 0, 3000.0)]
    r = _record(trace=Trace(ks), counters={"batch": B, "rows": L, "steps": 1000,
                                           "ipa_attention.launches.f32": 8000},
                window_s=10.0)
    assert harness.read_metric("ipa_attention_roofline", r) == pytest.approx(50.0)
    assert harness.read_metric("gemm_ms.structure", r) == pytest.approx(1.0)
    assert harness.read_metric("other_kernels_ms.structure", r) == pytest.approx(150.0)
    assert harness.read_metric("ipa_launches_per_step", r) == 8
    mfu = harness.read_metric("mfu.structure", r)
    assert mfu == pytest.approx(100 * roofline_structure.forward_flops(B, L) * 100
                                / roofline.PEAK_FP32)
    # a program without the kernel or its counter: nothing to read
    r = _record(trace=Trace([("elementwise_kernel", 0, 1.0)]), counters={"batch": B, "rows": L,
                                                                        "steps": 10})
    for name in ("ipa_attention_roofline", "gemm_ms.structure", "other_kernels_ms.structure",
                 "ipa_launches_per_step"):
        assert harness.read_metric(name, r) is None, name
    assert harness.read_metric("structure_context_ms", r) is None


def test_flops_match_torchs_count_of_the_reference():
    """``forward_flops`` less what torch's counter does not count (the point
    distances and a . v_pts, elementwise in the reference) is the counter's
    reading of the reference's forward."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.inputs import make_pool
    from benchmark.reference.check import model_batch

    w = ref.make_weights(1, "cpu")
    b = model_batch(make_pool(2, 3), [0, 1], "cpu")
    q = ref.normalize(torch.randn(2, 16, 4))
    with torch.no_grad():
        ctx = ref.context(w, b)
        with FlopCounterMode(display=False) as fc:
            ref.score(w, ctx, q, torch.randn(2, 16, 3), None, torch.full((2,), 0.5))
    rs = roofline_structure
    elementwise = 2 * rs.BLOCKS * 96 * 96 * rs.H * (9 * rs.PQ + 6 * rs.PV)
    assert fc.get_total_flops() == rs.forward_flops(2) - elementwise
    assert rs.ipa_attention_bytes(64) / roofline.PEAK_BYTES > rs.ipa_attention_flops(64) / \
        roofline.PEAK_FP32
