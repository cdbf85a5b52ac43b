"""Wrappers the harness puts around calls into the program: host spans, and
the records the output check needs. They change no arithmetic and no order
of the program's work.

- ``ServiceTap`` wraps a ``SamplerService``'s ``dispatch`` and ``finalize``
  on the instance: the host time of each call (the spans ``dispatch`` and
  ``finalize``), and per dispatched batch its number, the pool entries in
  its rows (by their content) and the seed of the generator it was given.
  For the batch chosen for the check it arms the ``ChainTap``.
- ``ChainTap`` copies the sampler's chain state, on the device, after every
  ``_Graphed.run`` (a replay of ``STEPS_PER_GRAPH`` steps), or every
  ``SEGMENT`` eager steps where the chain runs without graphs (the CPU), for
  the armed batch only. The reference follows the chain from those states.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List

from benchmark.trace import span

SEGMENT = 10


def entry_key(entry) -> str:
    """A complex's identity: the digest of its peptide frames and pocket frames."""
    import numpy as np

    h = hashlib.sha1(np.ascontiguousarray(entry["frames"], np.float32).tobytes())
    h.update(np.ascontiguousarray(entry["pocket_frames"], np.float32).tobytes())
    return h.hexdigest()


class ChainTap:
    def __init__(self, steps: int):
        self.steps = steps
        self.armed = False
        self.states: List[tuple] = []
        self._k = 0
        self._in_run = threading.local()
        self._undo = []

    def arm(self) -> None:
        self.states, self._k, self.armed = [], 0, True

    def disarm(self) -> List[tuple]:
        self.armed = False
        return self.states

    def _keep(self, chain) -> None:
        self.states.append((self._k, chain.q.clone(), chain.t.clone(), chain.tors.clone()))

    def install(self) -> "ChainTap":
        from pmhc_tpu_torch.diffusion import sampler

        tap = self
        orig_run, orig_step = sampler._Graphed.run, sampler.Chain.step

        def run(graphed, n):
            tap._in_run.on = True
            try:
                orig_run(graphed, n)
            finally:
                tap._in_run.on = False
            if tap.armed:
                tap._k += n
                tap._keep(graphed.chain)

        def step(chain, forward, rand):
            orig_step(chain, forward, rand)
            if tap.armed and not getattr(tap._in_run, "on", False):
                tap._k += 1
                if tap._k % SEGMENT == 0 or tap._k == tap.steps:
                    tap._keep(chain)

        sampler._Graphed.run, sampler.Chain.step = run, step
        self._undo = [(sampler._Graphed, "run", orig_run), (sampler.Chain, "step", orig_step)]
        return self

    def uninstall(self) -> None:
        for cls, name, fn in self._undo:
            setattr(cls, name, fn)
        self._undo = []


class ServiceTap:
    """Per dispatched batch: ``batches[i] = {"keys", "n", "seed", "states"}``."""

    def __init__(self, service, chain: ChainTap, check, spans: Dict[str, list]):
        """``check``: the batch numbers to follow, or a function of (batch
        number, rows dispatched before it, its rows) that says so."""
        self.service, self.chain, self.check, self.spans = service, chain, check, spans
        self.batches: List[dict] = []
        self.rows = 0
        self._dispatch, self._finalize = service.dispatch, service.finalize
        service.dispatch, service.finalize = self.dispatch, self.finalize

    def dispatch(self, entries, generator=None, id=None):
        i = len(self.batches)
        rec = {"keys": [entry_key(e) for e in entries], "n": len(entries),
               "seed": None if generator is None else generator.initial_seed(), "states": None}
        self.batches.append(rec)
        follow = self.check(i, self.rows, len(entries)) if callable(self.check) else i in self.check
        self.rows += len(entries)
        if follow:
            self.chain.arm()
        t0 = time.monotonic()
        try:
            with span("dispatch"):
                handle = self._dispatch(entries, generator, id=id)
        finally:
            if follow:
                rec["states"] = self.chain.disarm()
        self.spans.setdefault("dispatch", []).append(time.monotonic() - t0)
        return handle

    def finalize(self, handle):
        t0 = time.monotonic()
        with span("finalize"):
            out = self._finalize(handle)
        self.spans.setdefault("finalize", []).append(time.monotonic() - t0)
        return out

    def remove(self) -> None:
        self.service.dispatch, self.service.finalize = self._dispatch, self._finalize


def pick(seed: int, salt: int, n: int, k: int = 1) -> List[int]:
    """``k`` distinct indices below ``n`` drawn from the run's seed."""
    import numpy as np

    rng = np.random.default_rng([int(seed) % (2 ** 63), salt])
    return sorted(int(x) for x in rng.choice(n, size=min(k, n), replace=False))

