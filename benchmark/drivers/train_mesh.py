"""Data-parallel training on a mesh of cards, as ``train_cli --mesh-data N``
runs it.

The program: one process a card (``parallel.distributed.spawn``, NCCL),
``make_mesh(data=N)``, ``Trainer(mesh=...)`` driven by ``train_batch`` once a
step with the global batch (B a card) on every rank; each rank keeps its
rows, draws the global batch's timesteps and noise, and all gradients and
loss sums go through one all-reduce a step. The global batches are drawn
from the seed over a pool of entries held on the host (a fresh permutation
each epoch), gathered before the window.

Set-up takes the first three steps (the check's readings, as on one card),
warms up, and times a few steps to fix the window's step count, which rank 0
broadcasts so that every rank runs the same steps. The window runs from a
barrier to the end of the last step on every card. A traced run then traces
``trace_seconds`` more on every card; ``busy_s`` and ``window_s`` are the
cards' means, and every card's trace goes into the record. Each rank reports
the modules of JAX or the JAX package it loaded, once its work is done, for
the result to be refused on.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from benchmark.drivers.train import CHECK_STEPS, index_rows, make_trainer, readings, trainer_seed
from benchmark.harness import Record, forbidden_modules
from benchmark.inputs import make_pool
from benchmark.reference import check as ref_check
from benchmark.reference import model as ref
from benchmark.trace import Tracer, span

BATCH_KEYS = ("mask", "frames", "features", "torsions", "torsions_mask", "pocket_features",
              "pocket_mask", "pocket_frames")

# the traffic's sizes cut to what the CPU runs in seconds (``benchmark/tests/tiny.py``)
TINY_TRAFFIC = {"batch_per_rank": 2, "entries": 16, "ranks": 2, "batches": 2,
                "warmup_steps": 1, "calibration_steps": 2}


def rank_main(cell, seed: int, seconds: float, trace: bool, mode, prepare):
    """One rank's run; rank 0 returns the run's readings, the others their
    card's trace and memory peak; each the forbidden modules it loaded."""
    import torch
    import torch.distributed as dist

    from pmhc_tpu_torch.parallel import make_mesh

    if prepare is not None:
        prepare()
    tr = cell.traffic
    ranks, G = tr["ranks"], tr["batch_per_rank"] * tr["ranks"]
    on_card = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    mesh = make_mesh(ranks)
    w = ref.make_weights(seed, dev)
    pool = make_pool(tr["entries"], seed)
    trainer = make_trainer(cell, w, seed, dev, mode, mesh=mesh)
    rows = index_rows(seed, tr["entries"], G)
    first = np.stack([next(rows) for _ in range(CHECK_STEPS)])
    batch = lambda r: {k: pool[k][r] for k in BATCH_KEYS}  # noqa: E731
    losses, grads, delta = readings(trainer, lambda k: [trainer.train_batch(batch(first[k]))])
    losses = [x / G for x in losses]
    cycle = [batch(next(rows)) for _ in range(tr["batches"])]
    spans = []

    def steps(n):
        for k in range(n):
            t = time.monotonic()
            with span("train_batch"):
                trainer.train_batch(cycle[k % len(cycle)])
            spans.append(time.monotonic() - t)
        sync()

    steps(tr["warmup_steps"])
    t = time.monotonic()
    steps(tr["calibration_steps"])
    n = torch.tensor([math.ceil(seconds * tr["calibration_steps"] / (time.monotonic() - t))],
                     device=dev)
    dist.broadcast(n, 0)
    n = int(n)
    spans.clear()
    dist.barrier()
    start = time.monotonic()
    steps(n)
    dist.barrier()
    window = time.monotonic() - start
    out = {"start": start, "window_s": window, "steps": n, "spans": list(spans)}
    if trace:
        tracer = Tracer(dev)
        tracer.start()
        steps(max(1, math.ceil(n * tr["trace_seconds"] / seconds)))
        tracer.stop()
        out.update(busy_s=tracer.trace.busy_s, trace_window_s=tracer.trace.window_s,
                   trace=tracer.trace)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if dist.get_rank() == 0:
        del trainer
        if on_card:
            torch.cuda.empty_cache()
        out["checks"] = ref_check.check_training(
            w, pool, first, trainer_seed(seed), trainer_seed(seed) + 1, dev, losses, grads,
            delta, tr["lr"], cell.config["noise_step_count"])
    out["forbidden"] = forbidden_modules(sys.modules)
    return out


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda", mode=None,
        prepare=None) -> Record:
    from pmhc_tpu_torch.parallel.distributed import spawn

    tr = cell.traffic
    outs = spawn(rank_main, tr["ranks"], args=(cell, seed, seconds, trace,
                                                mode or cell.config["mode"], prepare),
                 device=device, timeout=seconds + tr["timeout_s"])
    r0 = outs[0]
    rec = Record(cell, cards=tr["ranks"])
    rec.setup_s = r0["start"] - t0
    rec.window_s = r0["window_s"]
    rec.spans = {"dispatch": r0["spans"]}
    rec.completed = rec.attempted = r0["steps"] * tr["batch_per_rank"] * tr["ranks"]
    rec.counters.update(steps=r0["steps"], batch=tr["batch_per_rank"])
    if trace:
        rec.trace = r0["trace"]
        rec.card_traces = [o["trace"] for o in outs]
        rec.counters.update(busy_s=sum(o["busy_s"] for o in outs) / len(outs),
                            trace_window_s=sum(o["trace_window_s"] for o in outs) / len(outs))
    rec.memory_peak_bytes = max(o["memory_peak_bytes"] for o in outs)
    rec.checks = r0["checks"]
    rec.forbidden = sorted({m for o in outs for m in o["forbidden"]})
    return rec
