"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
metrics read.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) over a span of the
cell's work run after the measured window and keeps every device kernel and every host span as
``(name, start_us, end_us)``. ``Trace`` computes from those lists alone, so the
tests feed it synthetic ones: the union of kernel intervals (``busy_s``), the
traced window (``window_s``: from the first kernel's start to the last one's
end), device time by kernel name, and the longest idle gaps, each named by the
innermost benchmark span (``bench.*``) the host was in when the gap began.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

Interval = Tuple[str, float, float]  # (name, start us, end us)


@dataclass
class Trace:
    kernels: List[Interval]
    host: List[Interval] = field(default_factory=list)
    window_s: float = 0.0

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one kernel ran (the union of intervals)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def kernel_s(self, match: Iterable[str], exclude: bool = False) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name contains any of
        ``match`` (with ``exclude``: of every other kernel)."""
        match = tuple(match)
        sel = [k for k in self.kernels if any(m in k[0] for m in match) != exclude]
        return sum(e - s for _, s, e in sel) / 1e6, len(sel)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.kernels:
            out[n] = out.get(n, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The ``top`` longest gaps with no kernel running, named by the
        innermost ``bench.*`` host span open at the gap's start."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        gaps, end = [], None
        for _, s, e in ks:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = [h for h in self.host if h[0].startswith("bench.")]
        out = []
        for g0, g1 in gaps[:top]:
            open_ = [h for h in spans if h[1] <= g0 < h[2]]
            name = min(open_, key=lambda h: h[2] - h[1])[0] if open_ else "host outside spans"
            out.append((name, (g1 - g0) / 1e6))
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [
            [n, s] for n, s in self.idle_gaps()]}


class Tracer:
    """``torch.profiler`` over a span run after the measured window, so that
    the window of a traced run is the same as an untraced one's. The trace
    is ``self.trace``; its window is the device's, from the first operation
    recorded to the end of the last."""

    def __init__(self, device):
        self.device, self.prof, self.trace = device, None, None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.trace = from_profile(self.prof)
        self.prof = None


def from_profile(prof) -> Trace:
    import torch

    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            # a host span; the profiler also mirrors it on the device's timeline
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append((e.name, tr.start, tr.end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, tr.start, tr.end))
    window = (max(k[2] for k in kernels) - min(k[1] for k in kernels)) / 1e6 if kernels else 0.0
    return Trace(kernels, host, window)


def span(name: str):
    """A host span the trace can name idle gaps by (a no-op when not profiling)."""
    import torch

    return torch.profiler.record_function(f"bench.{name}")
