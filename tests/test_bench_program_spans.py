"""``benchmark/program_spans.py`` and the per-layer reader of the program's
spans (``pdb_ms.sample``), on synthetic spans: the spans by name, the
milliseconds per unit span, the reader on a synthetic record, and ``None``
from a program or a run without the reader's spans."""

import sys

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Trace
from pmhc_tpu_torch.utils.profiling import Span

MAIN = 1


def s(name, parent, t0_us, t1_us, id=None, thread=MAIN):
    """A program span from ``t0_us`` to ``t1_us`` (ns on the program's clock)."""
    return Span(name, id, parent, thread, int(t0_us * 1e3), int(t1_us * 1e3))


def sample_spans():
    """Two batches: dispatch (stage, chain, pin) and finalize (wait, pdb)."""
    out = []
    for b, t in enumerate((0.0, 1000.0)):
        out += [s("sampler.stage", "sampler.dispatch", t + 10, t + 110),
                s("sampler.chain", "sampler.dispatch", t + 110, t + 290),
                s("sampler.pin", "sampler.dispatch", t + 290, t + 300),
                s("sampler.dispatch", None, t + 5, t + 305, id=b),
                s("sampler.wait", "sampler.finalize", t + 410, t + 700),
                s("sampler.pdb", "sampler.finalize", t + 700, t + 900),
                s("sampler.finalize", None, t + 405, t + 905, id=b)]
    return out


def record(cell):
    trace = Trace([("k", 0, 10), ("k", 20, 30)], [("bench.dispatch", 0, 40)])
    return harness.Record(harness.load_cell(cell), trace=trace)


def test_named_picks_one_name_by_start():
    spans = list(reversed(sample_spans()))
    pdb = program_spans.named(spans, "sampler.pdb")
    assert [(x.start_ns, x.end_ns) for x in pdb] == [(700_000, 900_000), (1_700_000, 1_900_000)]
    assert program_spans.named(spans, "sampler.none") == []


@pytest.mark.parametrize("name, unit, ms", [
    ("sampler.pdb", "sampler.dispatch", 0.200),
    ("sampler.wait", "sampler.dispatch", 0.290),
    ("sampler.replay", "sampler.dispatch", None),  # no span of the name
    ("sampler.pdb", "trainer.step", None),         # no unit span
])
def test_per_unit_ms(name, unit, ms):
    got = program_spans.per_unit_ms(sample_spans(), name, unit)
    assert got == (None if ms is None else pytest.approx(ms))


def test_recorded_reads_the_program_and_copies(monkeypatch):
    from pmhc_tpu_torch.utils import profiling

    spans = sample_spans()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = program_spans.recorded()
    assert got == spans and got is not spans


def test_readers_on_synthetic_records(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", sample_spans)
    r = record("f32.sample.b64")
    assert harness.read_metric("pdb_ms.sample", r) == pytest.approx(0.200)
    # a third dispatch whose PDB text is not yet written counts as a batch
    third = s("sampler.dispatch", None, 2005, 2305, id=2)
    monkeypatch.setattr(program_spans, "recorded", lambda: sample_spans() + [third])
    assert harness.read_metric("pdb_ms.sample", r) == pytest.approx(0.400 / 3)


@pytest.mark.parametrize("absent", ["spans", "pdb", "dispatch", "recorder", "program"])
def test_readers_give_none_without_the_programs_spans(monkeypatch, absent):
    """A program without the recorder (an older checkout), or a run without
    the reader's spans, reads as no metric."""
    import pmhc_tpu_torch.utils
    from pmhc_tpu_torch.utils import profiling

    r = record("f32.sample.b64")
    monkeypatch.setattr(profiling, "spans", sample_spans)
    assert harness.read_metric("pdb_ms.sample", r) == pytest.approx(0.200)
    if absent == "recorder":
        monkeypatch.delattr(profiling, "spans")
    elif absent == "program":
        monkeypatch.delattr(pmhc_tpu_torch.utils, "profiling")
        monkeypatch.setitem(sys.modules, "pmhc_tpu_torch.utils.profiling", None)
    else:
        keep = {"spans": (), "pdb": ("sampler.dispatch",), "dispatch": ("sampler.pdb",)}[absent]
        monkeypatch.setattr(profiling, "spans",
                            lambda: [x for x in sample_spans() if x.name in keep])
    assert harness.read_metric("pdb_ms.sample", r) is None
