"""CUDA graphs of the port's step bodies: the counterpart of the JAX
package's compiled step (``jax.jit`` of the train step, ``lax.scan`` over
the reverse chain and over K train steps).

A step body is a function of no arguments that reads and writes tensors it
closes over (its static inputs and state) and does nothing on the host that
a replay would have to repeat: every per-step scalar is a device tensor.
A ``Step`` takes one step of its body:

- the first time, it runs ``body`` eagerly on a side stream. That is a real step
  (its launches count as such) and it makes each kernel build, load and
  set its attributes before capture. Then it captures ``body`` with
  ``torch.cuda.graph`` into the graph's private memory pool, with every
  device generator the body draws from registered
  (``CUDAGraph.register_generator_state``), so that each replay draws the
  generator's next numbers;
- after that, it replays the graph.

``GraphCache`` keeps the steps (with their static tensors and state) by
key: path, backend, mode and shapes (a sampler's entry keeps one step per
count of steps a graph holds).

The kernel wrappers' launch counters count Python calls, and a capture runs
the wrappers' Python once without launching anything. So a capture takes
its counts back and keeps them as the graph's launches; each replay adds
them (``Graph.replay``). A count then means launches on the card, as in
eager mode.

There is no eager fallback: a capture that fails raises. ``use_graphs``
says where graphs run: by default on a CUDA device, never on the CPU (the
tests run the same bodies eagerly there).
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Sequence

import torch

from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.utils.profiling import count, launch_counters, span


def use_graphs(graphs: bool | None, device: torch.device) -> bool:
    """Whether a path on ``device`` runs from CUDA graphs: ``None`` means
    yes on a CUDA device and no elsewhere; ``True`` off a CUDA device
    raises."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}: pass graphs=False")
    return bool(graphs)


def batch_tensors(batch: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a model batch in key order (a ``RigidArray`` gives
    its quats and translations): a captured step's static inputs, which
    another batch of the same signature is copied into."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        out += [v.quats, v.trans] if isinstance(v, RigidArray) else \
            [v] if isinstance(v, torch.Tensor) else []
    return out


def own_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` with every tensor copied: a graph's own static inputs,
    which no caller holds."""
    own = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
    return {k: RigidArray(own(v.quats), own(v.trans)) if isinstance(v, RigidArray) else own(v)
            for k, v in batch.items()}


class Graph:
    """A captured step body and the kernel launches of one replay."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launches: List[Dict[str, int]]):
        self.graph = graph
        self.launches = launches  # per counter, the launches of one replay
        self._counters = list(launch_counters().values())

    def replay(self) -> None:
        self.graph.replay()
        for counter, per in zip(self._counters, self.launches):
            for k, n in per.items():
                counter[k] += n


def warm_up(body: Callable[[], None]) -> None:
    """Run ``body`` eagerly on a side stream, ordered after and before the
    current stream's work."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
    main.wait_stream(side)


def capture(body: Callable[[], None], generators: Sequence[torch.Generator] = ()) -> Graph:
    """Capture one call of ``body`` (run eagerly before, see ``warm_up``)
    with ``generators`` registered; raises if the capture fails.

    Python's cyclic garbage collector is run before the capture and kept
    off during it: a collection inside the capture frees the memory of
    dead reference cycles, and on the card that invalidated a capture at
    its next allocation (``torch.cuda.graph`` no longer collects on entry
    unless ``torch.compiler.config.force_cudagraph_gc`` is set). The span
    ``graphs.capture`` covers it; the counter ``graphs.captures`` counts it."""
    count("graphs.captures")
    with span("graphs.capture"):
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            g.register_generator_state(gen)
        counters = list(launch_counters().values())
        before = [dict(c) for c in counters]
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            # thread_local: a server thread may fetch results while another
            # thread captures
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                body()
        finally:
            if collecting:
                gc.enable()
            launches = [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.update(b)  # the capture launched nothing
        return Graph(g, launches)


class Step:
    """A step body and, once it has run, its graph: the first call runs
    ``body`` eagerly on a side stream (a real step) and captures it, every
    later call replays the capture."""

    def __init__(self, body: Callable[[], None], generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.generators = tuple(generators)
        self.graph: Graph | None = None

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            return
        warm_up(self.body)
        self.graph = capture(self.body, self.generators)


class GraphCache:
    """Captured steps (with whatever static tensors and state the caller
    keeps beside them) by key: path, backend, mode and shapes. The least
    recently used entry is dropped beyond ``max_entries``."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()

    def get(self, key: Hashable):
        value = self._entries.get(key)
        if value is not None:
            self._entries.move_to_end(key)
        return value

    def put(self, key: Hashable, value) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)
