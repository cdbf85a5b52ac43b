"""The metric readers and the trace reduction on synthetic records, and the
yardstick's FLOP count against the system's own."""

import math

import pytest

from benchmark import harness, roofline
from benchmark.tests.tiny import KEPT_OUT, tiny_cell
from benchmark.trace import Trace


def record(cell="f32.sample.b64", **kw):
    r = harness.Record(tiny_cell(cell) if cell in KEPT_OUT else harness.load_cell(cell))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_busy_idle_and_gaps():
    t = Trace([("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 100, 101)],
              [("bench.finalize", 35, 60), ("bench.dispatch", 19, 25), ("bench.outer", 0, 300)])
    assert t.busy_s == pytest.approx(31e-6)
    gaps = t.idle_gaps()
    assert gaps[0] == ("bench.finalize", pytest.approx(60e-6))
    assert gaps[1] == ("bench.dispatch", pytest.approx(10e-6))
    assert t.kernel_s(["a", "c"]) == (pytest.approx(20e-6), 2)
    assert t.kernel_s(["a", "c"], exclude=True) == (pytest.approx(16e-6), 2)
    b = t.breakdown()
    assert b["device_ops"][0] == ["b", pytest.approx(15e-6)] and len(b["idle_gaps"]) == 2


def test_rates_and_tail():
    r = record(completed=640, window_s=6.4, setup_s=12.5)
    assert harness.read_metric("samples_per_s", r) == pytest.approx(100.0)
    assert harness.read_metric("setup_s", r) == 12.5
    r = record("f32.serve.open", latencies=[float(i) for i in range(1, 101)])
    assert harness.read_metric("request_p95_s", r) == 95.0
    r.latencies[-10:] = [math.inf] * 10
    assert harness.read_metric("request_p95_s", r) is None


def test_kernel_readers():
    B = 64
    pair = sum(roofline.fused_bound_s(B, H, O, "f32") for H, O in roofline.LAYERS)
    # 10 steps, each launch at twice its bound
    kernels = [("void egnn_fused_kernel<0>(x)", 1e6 * i * pair, 1e6 * (i * pair + pair))
               for i in range(20)]
    kernels += [("elementwise", 0, 1000.0)]
    r = record(trace=Trace(kernels), counters={"batch": B, "busy_s": 0.75, "trace_window_s": 1.0})
    assert harness.read_metric("egnn_fused_roofline", r) == pytest.approx(50.0)
    assert harness.read_metric("other_kernels_ms.sample", r) == pytest.approx(1.0 / 10 * 100)
    assert harness.read_metric("idle_pct.sample", r) == pytest.approx(25.0)
    assert harness.read_metric("egnn_fused_roofline", record()) is None


def test_loop_and_mesh_readers():
    B = 64
    step = sum(roofline.loop_bound_s(B, H, O, "fast-f32", backward=b)
               for H, O in roofline.LAYERS for b in (False, True))
    ks = [("egnn_loop_fwd_kernel", 0, 1e6 * step / 2), ("egnn_loop_fwd_kernel", 0, 0),
          ("egnn_loop_bwd_kernel", 0, 1e6 * step / 2), ("ncclDevKernel_AllReduce", 0, 100.0)]
    r = record("ff32.train.dp4", trace=Trace(ks), counters={"batch": B, "steps": 10},
               window_s=1.0, cards=4)
    assert harness.read_metric("egnn_loop_roofline", r) == pytest.approx(100.0)
    assert harness.read_metric("allreduce_ms.train", r) == pytest.approx(0.1)
    # on a mesh each all-reduce is taken on the card where it ran shortest
    card = lambda a, b: Trace(ks[:3] + [("ncclDevKernel_AllReduce", 0, a),  # noqa: E731
                                        ("ncclDevKernel_AllReduce", 500, 500 + b)])
    r.card_traces = [card(100.0, 20.0), card(30.0, 90.0), card(60.0, 60.0)]
    r.trace = r.card_traces[0]
    assert harness.read_metric("allreduce_ms.train", r) == pytest.approx(0.05)
    r.card_traces[1] = Trace(ks)
    assert harness.read_metric("allreduce_ms.train", r) is None
    r.trace = r.card_traces[0] = Trace(ks)
    mfu = harness.read_metric("mfu.train", r)
    assert mfu == pytest.approx(100 * 3 * roofline.forward_flops(B) * 10 / (989e12 / 3))


def test_flops_match_the_systems_count():
    from pmhc_tpu_torch.tools import flops

    for B in (1, 64, 256):
        assert roofline.forward_flops(B) == flops.forward_flops(B)
    assert roofline.PEAK_STEP == flops.PEAKS
    assert roofline.layer_params(23, 64) + roofline.layer_params(64, 1) == 79195


def test_bounds_are_operation_bound_at_the_cells_shapes():
    for mode in ("f32", "fast-f32"):
        for H, O in roofline.LAYERS:
            t = roofline.fused_bound_s(64, H, O, mode)
            assert t > 0
            assert roofline.loop_bound_s(64, H, O, mode, True) > roofline.loop_bound_s(
                64, H, O, mode, False)
