"""The program's own host spans, for the per-layer readers of a ``--trace 1``
run.

The program (``pmhc_tpu_torch.utils.profiling``) records its spans while a
``torch.profiler`` session records, so in a benchmark run they are the
traced span of the cell's work and nothing else. ``recorded`` reads them;
a program without the recorder gives none, and every reader then returns
``None``. A span is ``(name, id, parent, thread, start_ns, end_ns)`` on the
host's ``perf_counter_ns`` clock.

Under the profiler each CUDA graph launch blocks the host for about the
graph's device time, so most of the traced host split is the profiler's
(``PERF.md`` §5). A span is read here only where its traced value follows
the untraced window's: today ``sampler.pdb``, for ``pdb_ms.sample``.
"""

from __future__ import annotations

from typing import Optional


def recorded() -> list:
    """The spans the program recorded in this process ([] without a recorder)."""
    try:
        from pmhc_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def named(spans, name: str) -> list:
    """The spans called ``name``, by start."""
    return sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)


def per_unit_ms(spans, name: str, unit: str) -> Optional[float]:
    """Milliseconds in ``name`` spans per ``unit`` span; None without either."""
    mine, n = named(spans, name), len(named(spans, unit))
    if not mine or not n:
        return None
    return sum(s.end_ns - s.start_ns for s in mine) / 1e6 / n
