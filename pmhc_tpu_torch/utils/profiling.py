"""Tracing and numerical-debug hooks.

Counterpart of ``pmhc_tpu/utils/profiling.py``:

- ``profile_trace``: a context manager around ``torch.profiler`` (CPU
  activity, and the card's when there is one) that writes a Chrome trace
  (``trace.json``, for ``chrome://tracing`` or Perfetto) into a directory;
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, so the
  backward op that produced a NaN raises with the forward op's traceback.
"""

from __future__ import annotations

import contextlib
import os

import torch


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
