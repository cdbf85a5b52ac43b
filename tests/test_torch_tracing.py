"""The port's recorder (``utils/profiling.py``) and its spans, on the CPU.

- Off (the default), a ``SamplerService`` dispatch / finalize and a
  ``Trainer.train_indices`` call record no span and open no record
  function (neither ``torch.profiler.record_function`` nor the
  ``RecordFunctionFast`` the recorder opens).
- On (``record(True)``, and under a ``torch.profiler`` session), they record
  the span tree: ``sampler.dispatch`` over ``sampler.stage``,
  ``sampler.chain`` (over ``sampler.context`` and a ``sampler.replay`` per
  replay) and ``sampler.pin``; ``sampler.finalize`` over ``sampler.wait``
  and ``sampler.pdb``, with the id given to ``dispatch`` (None where none
  was given); ``trainer.call`` over ``trainer.step``
  (the step's number) over ``trainer.replay`` and, on the steps that check,
  ``trainer.nan_check``. The sampler and the trainer run their graph paths
  with an eager stand-in for ``Step``. Under the profiler each span opened
  one record function, and the spans are among ``prof.events()`` as host
  events that are not user annotations (which the profiler would mirror
  onto the card's timeline).
- The batcher and ``sample_cli``: the batch number as the service's span
  id; the batcher's finalize on its own thread.
- ``counters()`` holds the kernel wrappers' ``LAUNCHES`` and
  ``graphs.captures``; a capture's launches come back with each replay.
- Spans and counts from many threads keep their parents and lose nothing.
"""

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from pmhc_tpu_torch import serve as serve_module
from pmhc_tpu_torch.data import DeviceDataset
from pmhc_tpu_torch.data.realistic import realistic_packed
from pmhc_tpu_torch.diffusion import DiffusionConfig
from pmhc_tpu_torch.diffusion import sampler as sampler_module
from pmhc_tpu_torch.models import ScoreNetwork, ScoreNetworkConfig
from pmhc_tpu_torch.ops import egnn_fused, egnn_loop, egnn_pallas, sampler_step
from pmhc_tpu_torch.serve import BatchingSampler, SamplerService, dummy_entry
from pmhc_tpu_torch.train import TrainConfig, Trainer
from pmhc_tpu_torch.train import trainer as trainer_module
from pmhc_tpu_torch.utils import profiling
from pmhc_tpu_torch.utils.graphs import capture

torch.set_num_threads(1)
CPU = torch.device("cpu")
T = 2


@pytest.fixture
def recorder():
    """A recorder with no spans, off, and left so."""
    profiling.record(False)
    profiling.clear()
    yield profiling
    profiling.record(False)
    profiling.clear()


@pytest.fixture
def rf_calls(monkeypatch):
    """The names ``torch.profiler.record_function`` and the
    ``RecordFunctionFast`` the recorder opens were called with."""
    calls = []

    def counting(owner, attr):
        real = getattr(owner, attr)

        def call(name, *args, **kwargs):
            calls.append(name)
            return real(name, *args, **kwargs)

        monkeypatch.setattr(owner, attr, call)

    counting(torch.profiler, "record_function")
    counting(torch._C._profiler, "_RecordFunctionFast")
    return calls


class EagerStep:
    """``utils/graphs.Step`` on the CPU: every call runs the body, so the
    graph paths (the sampler's replays, the trainer's ``_replay``) run
    without a card."""

    def __init__(self, body, generators=()):
        self.body = body

    def __call__(self):
        self.body()


def _service():
    model = ScoreNetwork(generator=torch.Generator().manual_seed(0))
    return SamplerService(model.state_dict(), batch_size=3, noise_step_count=T, device="cpu")


def _graph_paths(monkeypatch):
    for module in (serve_module, sampler_module, trainer_module):
        monkeypatch.setattr(module, "use_graphs", lambda graphs, device: True)
    for module in (sampler_module, trainer_module):
        monkeypatch.setattr(module, "Step", EagerStep)


def _trainer():
    return Trainer(ScoreNetworkConfig(backend="fused", noise_step_count=8),
                   DiffusionConfig(noise_step_count=8, t_per_batch=False),
                   TrainConfig(seed=5, nan_check_every=2), device="cpu")


def _entries(n=2):
    return [dummy_entry(protein_len=5 + i, seed=i) for i in range(n)]


def _work(monkeypatch, graphs=False):
    """Two sampled batches (a seeded generator and no id, then batch 5's
    with its number), then three training steps; returns the trainer."""
    if graphs:
        _graph_paths(monkeypatch)
    svc = _service()
    svc.finalize(svc.dispatch(_entries(), torch.Generator().manual_seed(11)))
    svc.finalize(svc.dispatch(_entries(1), svc.batch_generator(5), id=5))
    data = DeviceDataset(realistic_packed(8, seed=8), CPU)
    idx = np.random.default_rng(2).permutation(8)[:6].reshape(3, 2)
    tr = _trainer()
    tr.train_indices(data, idx)
    return tr


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return {k: sorted(v, key=lambda s: s.start_ns) for k, v in out.items()}


def _inside(child, parent):
    return (child.thread == parent.thread and parent.start_ns <= child.start_ns
            and child.end_ns <= parent.end_ns)


def test_off_records_no_span_and_opens_no_record_function(recorder, rf_calls, monkeypatch):
    _work(monkeypatch)
    _work(monkeypatch, graphs=True)
    assert recorder.spans() == []
    assert rf_calls == []


@pytest.mark.parametrize("how", ["record", "profiler"])
def test_on_records_the_span_tree(recorder, rf_calls, monkeypatch, how):
    prof = None
    if how == "record":
        recorder.record(True)
        tr = _work(monkeypatch, graphs=True)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tr = _work(monkeypatch, graphs=True)
    spans = recorder.spans()
    by = _by_name(spans)
    assert set(by) == {"sampler.dispatch", "sampler.stage", "sampler.chain", "sampler.context",
                       "sampler.replay", "sampler.pin", "sampler.finalize", "sampler.wait",
                       "sampler.pdb", "trainer.call", "trainer.step", "trainer.replay",
                       "trainer.nan_check"}

    # sampling: a batch's dispatch and finalize share its id
    assert [s.id for s in by["sampler.dispatch"]] == [None, 5]
    assert [s.id for s in by["sampler.finalize"]] == [None, 5]
    for top in ("sampler.dispatch", "sampler.finalize", "trainer.call"):
        assert all(s.parent is None for s in by[top])
    for parent, children in (("sampler.dispatch", ("sampler.stage", "sampler.chain",
                                                    "sampler.pin")),
                             ("sampler.chain", ("sampler.context", "sampler.replay")),
                             ("sampler.finalize", ("sampler.wait", "sampler.pdb")),
                             ("trainer.call", ("trainer.step",)),
                             ("trainer.step", ("trainer.replay", "trainer.nan_check"))):
        for name in children:
            assert all(s.parent == parent for s in by[name]), name
            assert all(any(_inside(s, p) for p in by[parent]) for s in by[name]), name
    # T = 2 steps: one replay a chain
    for name in ("sampler.stage", "sampler.chain", "sampler.context", "sampler.replay",
                 "sampler.pin", "sampler.wait", "sampler.pdb"):
        assert len(by[name]) == 2, name

    # training: one call, three steps numbered 1-3, a replay each, the NaN
    # check (every 2 steps) on step 2 only
    assert len(by["trainer.call"]) == 1 and tr.global_step == 3
    assert [s.id for s in by["trainer.step"]] == [1, 2, 3]
    assert len(by["trainer.replay"]) == 3
    (check,) = by["trainer.nan_check"]
    assert [s.id for s in by["trainer.step"] if _inside(check, s)] == [2]

    if how == "profiler":
        assert sorted(rf_calls) == sorted(s.name for s in spans)
        events = [e for e in prof.events() if e.name in by]
        assert {e.name for e in events} == set(by)
        assert not any(e.is_user_annotation for e in events)
    else:
        assert rf_calls == []


def test_batcher_spans_share_the_batch_number(recorder):
    recorder.record(True)
    batcher = BatchingSampler(_service(), max_wait_ms=100)
    try:
        futures = batcher.submit_many(_entries(2))
        assert all(f.result(timeout=120).endswith(b"END\n") for f in futures)
    finally:
        batcher.close()
    assert not batcher._collector.is_alive() and not batcher._finisher.is_alive()
    by = _by_name(recorder.spans())
    (dispatch,), (finalize,) = by["sampler.dispatch"], by["sampler.finalize"]
    assert dispatch.id == finalize.id == 0
    assert dispatch.thread == batcher._collector.ident != finalize.thread
    assert finalize.thread == batcher._finisher.ident
    assert set(by) == {"sampler.dispatch", "sampler.stage", "sampler.chain", "sampler.pin",
                       "sampler.finalize", "sampler.wait", "sampler.pdb"}


def test_sample_cli_numbers_its_batches(recorder, tmp_path):
    """``sample_cli`` gives each batch's spans the batch's number: 3
    entries at batch 2, a full batch and a short one."""
    from pmhc_tpu_torch.cli import sample_cli

    data, model = str(tmp_path / "test.npz"), str(tmp_path / "model.pth")
    realistic_packed(3, seed=1).save(data)
    torch.save(ScoreNetwork(generator=torch.Generator().manual_seed(0)).state_dict(), model)
    recorder.record(True)
    sample_cli.main([model, data, "-T", "2", "-b", "2", "--num-workers", "0", "--device", "cpu",
                     "--output-dir", str(tmp_path / "out")])
    by = _by_name(recorder.spans())
    assert [s.id for s in by["sampler.dispatch"]] == [0, 1]
    assert [s.id for s in by["sampler.finalize"]] == [0, 1]


def test_counters_hold_launch_counts_and_captures(recorder, monkeypatch):
    launches = {"egnn_fused": egnn_fused.LAUNCHES, "egnn_loop": egnn_loop.LAUNCHES,
                "egnn_pallas": egnn_pallas.LAUNCHES, "sampler_step": sampler_step.LAUNCHES}
    counts = recorder.counters()
    for mod, per in launches.items():
        assert all(counts[f"{mod}.launches.{k}"] == n for k, n in per.items())

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())

    def body():  # a step body whose wrappers launch #1 twice
        egnn_fused.LAUNCHES["fp32"] += 2

    recorder.record(True)
    before = recorder.counters()["egnn_fused.launches.fp32"]
    graph = capture(body)
    counts = recorder.counters()
    assert counts["graphs.captures"] == 1
    assert counts["egnn_fused.launches.fp32"] == before  # a capture launches nothing
    assert [s.name for s in recorder.spans()] == ["graphs.capture"]
    graph.replay()
    assert recorder.counters()["egnn_fused.launches.fp32"] == before + 2


def test_spans_and_counts_from_many_threads(recorder):
    recorder.record(True)
    n_threads, n = 16, 200

    def work(i):
        for k in range(n):
            with recorder.span("outer", (i, k)):
                with recorder.span("inner", (i, k)):
                    recorder.count("stress")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    spans = recorder.spans()
    assert len(spans) == 2 * n_threads * n
    assert recorder.counters()["stress"] == n_threads * n
    outer = {s.id: s for s in spans if s.name == "outer"}
    assert len(outer) == n_threads * n and all(s.parent is None for s in outer.values())
    for s in spans:
        if s.name == "inner":
            assert s.parent == "outer" and _inside(s, outer[s.id])
