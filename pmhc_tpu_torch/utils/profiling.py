"""Tracing, counters and numerical-debug hooks.

Counterpart of ``pmhc_tpu/utils/profiling.py``:

- ``profile_trace``: a context manager around ``torch.profiler`` (CPU
  activity, and the card's when there is one) that writes a Chrome trace
  (``trace.json``, for ``chrome://tracing`` or Perfetto) into a directory;
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, so the
  backward op that produced a NaN raises with the forward op's traceback.

And the port's one recorder of host spans and counters:

- ``span(name, id=None)``: a context manager around a layer's work. Off
  (the default) it tests one flag and returns a shared null context: no
  clock reading, no allocation, no ``record_function``. It is on while a
  ``torch.profiler`` session records, or after ``record(True)``. An on span
  keeps a ``Span`` (name, id, the name of the span open on the same thread
  when it opened, thread, start and end in ``time.perf_counter_ns``); while
  the profiler records it also opens a record function of its name, so the
  program's spans lie on the kernels' clock in every trace the profiler
  writes (``profile_trace``, the CLIs' ``--profile-dir``). It is a plain
  host event (``RecordFunctionFast``), not ``torch.profiler.record_function``:
  the profiler mirrors a ``record_function`` range onto the card's timeline
  as a device event over the kernels launched in it, which a reader of the
  trace would count as device work.
- ``count(name, n=1)``: a counter, always on (counters are bumped off the
  per-step path). ``counters()`` reports them beside the kernel wrappers'
  launch counts (``LAUNCHES`` of ``ops/egnn_fused.py``, ``egnn_loop.py``,
  ``egnn_pallas.py``, ``sampler_step.py``, as ``<module>.launches.<key>``),
  which stay where they are.
- ``spans()`` / ``counters()`` / ``clear()``: the readers. ``clear`` drops
  the spans and this module's counters (not the launch counts).

The names of the spans and counters, and the metrics that read them, are
listed in ``PERF.md`` §3.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Hashable, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block; write ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


class Span(NamedTuple):
    """A finished span: ``parent`` is the name of the span open on the same
    thread when it opened (None at the top); times in ``perf_counter_ns``."""

    name: str
    id: Optional[Hashable]
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


_NULL = contextlib.nullcontext()
_recording = False
_spans: List[Span] = []
_counts: Dict[str, int] = {}
_count_lock = threading.Lock()
_open = threading.local()  # .names: the names of this thread's open spans


def record(on: bool = True) -> None:
    """Record spans whether or not a profiler session records (tests, operators)."""
    global _recording
    _recording = bool(on)


def span(name: str, id: Optional[Hashable] = None):
    """A span around the enclosed block (see the module's docstring)."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _OnSpan(name, id)
    return _NULL


def _names() -> List[str]:
    names = getattr(_open, "names", None)
    if names is None:
        names = _open.names = []
    return names


class _OnSpan:
    __slots__ = ("name", "id", "parent", "start", "rf")

    def __init__(self, name: str, id: Optional[Hashable]):
        self.name, self.id = name, id

    def __enter__(self) -> None:
        names = _names()
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _names().pop()
        _spans.append(Span(self.name, self.id, self.parent, threading.get_ident(),
                           self.start, end))
        return False


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def launch_counters() -> Dict[str, Dict[str, int]]:
    """The kernel wrappers' launch counters by module (the dicts themselves)."""
    from pmhc_tpu_torch.ops import egnn_fused, egnn_loop, egnn_pallas, sampler_step

    return {"egnn_fused": egnn_fused.LAUNCHES, "egnn_loop": egnn_loop.LAUNCHES,
            "egnn_pallas": egnn_pallas.LAUNCHES, "sampler_step": sampler_step.LAUNCHES}


def spans() -> List[Span]:
    """The finished spans, in the order they ended."""
    return list(_spans)


def counters() -> Dict[str, int]:
    """This module's counters and the launch counts, by name."""
    with _count_lock:
        out = dict(_counts)
    for mod, launches in launch_counters().items():
        out.update({f"{mod}.launches.{k}": n for k, n in launches.items()})
    return out


def clear() -> None:
    """Drop the spans and this module's counters."""
    _spans.clear()
    with _count_lock:
        _counts.clear()
