"""Offline batch sampling, closed loop, as the sample CLI drives it.

The program: ``SamplerService`` (one batch shape, the full T-step reverse
chain from CUDA graphs, the layer kernel in the configuration's mode).
Batch i holds pool entries ``i*B .. i*B+B-1`` (mod the pool) with a
generator seeded from the run's seed and i. Batch i+1 is dispatched before
batch i is finalized to PDB text, so the card always has the next chain
queued while the host writes text. The window opens at the first dispatch
and closes when the last batch dispatched within ``seconds`` has its text:
all the work and all the time of the window. A traced run then runs the same
loop for ``trace_seconds`` more under the profiler.

Check: one batch, drawn from the seed among the first ones of the window,
followed by the reference (``reference/check.py``).
"""

from __future__ import annotations

import time

from benchmark.harness import Record
from benchmark.hooks import ChainTap, ServiceTap, entry_key, pick
from benchmark.inputs import make_pool, request_entry
from benchmark.reference import check as ref_check
from benchmark.reference import model as ref
from benchmark.trace import Tracer

# the traffic's sizes cut to what the CPU runs in seconds (``benchmark/tests/tiny.py``)
TINY_TRAFFIC = {"batch": 4, "pool": 8, "warmup_batches": 2}


def batch_generator_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + i) % (2 ** 63)


def make_service(cell, w, seed, device, mode):
    from pmhc_tpu_torch.serve import SamplerService

    cfg = cell.config
    return SamplerService({k: v.clone() for k, v in w.items()}, batch_size=cell.traffic["batch"],
                          noise_step_count=cfg["noise_step_count"], backend=cfg["backend"],
                          bf16=mode == "bf16", fast_f32=mode == "fast-f32", seed=seed,
                          device=device)


def check_batches(cell, w, pool, keys, tap, texts, device) -> dict:
    """The reference's numbers over the checked batches (the worst of each)."""
    out: dict = {}
    for k, answers in texts.items():
        b = tap.batches[k]
        rows = [keys[x] for x in b["keys"]]
        rows += [rows[0]] * (cell.traffic["batch"] - len(rows))
        nums = ref_check.check_sampling(w, pool, rows, b["n"], b["seed"], b["states"], answers,
                                        cell.config["noise_step_count"], device)
        for name, v in nums.items():
            out[name] = max(out.get(name, 0.0), v)
    return out


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        mode=None) -> Record:
    import torch

    dev = torch.device(device)
    mode = mode or cell.config["mode"]
    tr = cell.traffic
    B, T = tr["batch"], cell.config["noise_step_count"]
    rec = Record(cell)
    w = ref.make_weights(seed, dev)
    pool = make_pool(tr["pool"], seed)
    entries = [request_entry(pool, i) for i in range(tr["pool"])]
    keys = {entry_key(e): i for i, e in enumerate(entries)}
    service = make_service(cell, w, seed, dev, mode)
    service.warmup()
    # the closed loop itself, until every batch in flight has its pinned
    # host buffers; with batch seeds no window batch uses
    pending = None
    for i in range(tr["warmup_batches"]):
        g = torch.Generator(device=dev).manual_seed(batch_generator_seed(~seed, i))
        handle = service.dispatch([entries[j % len(entries)] for j in range(B)], g)
        if pending is not None:
            service.finalize(pending)
        pending = handle
    service.finalize(pending)
    chain = ChainTap(T).install()
    check = set(pick(seed, 1, max(1, int(seconds * tr["check_within_first"]))))
    tap = ServiceTap(service, chain, check, rec.spans)
    count = [0]

    def dispatch():
        i = count[0]
        count[0] += 1
        rows = [entries[(i * B + j) % len(entries)] for j in range(B)]
        g = torch.Generator(device=dev).manual_seed(batch_generator_seed(seed, i))
        return i, tap.dispatch(rows, g)

    texts = {}

    def pump(duration):
        """Closed loop for ``duration`` s: (samples done, s to the last one)."""
        start = time.monotonic()
        pending, n = dispatch(), 0
        while True:
            nxt = dispatch() if time.monotonic() - start < duration else None
            k, handle = pending
            pdbs = tap.finalize(handle)
            done = time.monotonic()
            n += len(pdbs)
            if k in check:
                texts[k] = pdbs
            if nxt is None:
                return n, done - start
            pending = nxt

    rec.setup_s = time.monotonic() - t0
    rec.completed, rec.window_s = pump(seconds)
    batches = count[0]
    rec.spans = {k: list(v) for k, v in rec.spans.items()}
    rec.attempted = batches * B
    rec.counters.update(steps=batches * T, batch=B, batches=batches)
    if trace:
        tracer = Tracer(dev)
        tracer.start()
        pump(tr["trace_seconds"])
        tracer.stop()
        rec.trace = tracer.trace
        rec.counters.update(busy_s=rec.trace.busy_s, trace_window_s=rec.trace.window_s)
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    tap.remove()
    chain.uninstall()
    del service, tap.service
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.checks = check_batches(cell, w, pool, keys, tap, texts, dev)
    return rec

