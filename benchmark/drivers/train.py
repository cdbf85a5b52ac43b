"""Training on one card, as ``train_cli --device-data --steps-per-dispatch K``
runs it.

The program: ``Trainer`` (Adam, the published loss, a timestep per example,
the loop kernels in the configuration's mode, each step one CUDA graph replay
that gathers its rows from a ``DeviceDataset``), driven by
``Trainer.train_indices`` with K steps a call. The pool of entries lives on
the card; each step's B rows come from a fresh permutation of the pool per
epoch, drawn from the seed.

Set-up builds the trainer and takes its first three steps through the
window's own call on rows that all differ: the check's readings (the loss of
each step, the first gradients from Adam's first moment, the parameters'
change over the three). Then one more call warms up, and the window runs
calls of K steps until ``seconds`` have passed; it closes when the card has
finished the last one. A traced run then traces ``trace_seconds`` more.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator

import numpy as np

from benchmark.harness import Record
from benchmark.inputs import make_pool
from benchmark.reference import check as ref_check
from benchmark.reference import model as ref
from benchmark.trace import Tracer, span

PACKED_KEYS = ("mask", "frames", "features", "aatype", "torsions", "torsions_mask",
               "pocket_aatype", "pocket_features", "pocket_mask", "pocket_frames",
               "pocket_atom14_positions", "pocket_atom14_exists")
CHECK_STEPS = 3

# the traffic's sizes cut to what the CPU runs in seconds (``benchmark/tests/tiny.py``)
TINY_TRAFFIC = {"batch": 4, "entries": 16, "steps_per_dispatch": 2}


def index_rows(seed: int, n: int, batch: int) -> Iterator[np.ndarray]:
    """Rows of each step: the pool in a fresh order every epoch, ``batch`` at
    a time, the short end of an epoch dropped."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 2])
    while True:
        order = rng.permutation(n)
        for s in range(0, n - batch + 1, batch):
            yield order[s:s + batch]


def packed(pool: Dict[str, np.ndarray]):
    """The pool as the program's packed dataset."""
    from pmhc_tpu_torch.data.packed import PackedDataset

    n = len(pool["mask"])
    entries = [{"name": f"E{i:05d}", **{k: pool[k][i] for k in PACKED_KEYS}} for i in range(n)]
    proteins = [{k: pool[k][i, :pool["protein_len"][i]] for k in
                 ("protein_aatype", "protein_atom14_positions", "protein_atom14_exists")}
                for i in range(n)]
    return PackedDataset.from_entries(entries, proteins)


def make_trainer(cell, w, seed, device, mode, mesh=None):
    from pmhc_tpu_torch.diffusion import DiffusionConfig
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    cfg, tr = cell.config, cell.traffic
    T = cfg["noise_step_count"]
    return Trainer(ScoreNetworkConfig(backend=cfg["backend"], noise_step_count=T),
                   DiffusionConfig(noise_step_count=T, t_per_batch=False),
                   TrainConfig(learning_rate=tr["lr"], seed=trainer_seed(seed)),
                   params={k: v.clone() for k, v in w.items()}, bf16=mode == "bf16",
                   fast_f32=mode == "fast-f32", device=device, mesh=mesh)


def trainer_seed(seed: int) -> int:
    """The trainer's seed: its timesteps come from a CPU generator seeded
    with it, its noise from one on the card seeded with it + 1."""
    return int(seed) % (2 ** 62)


def readings(trainer, steps):
    """Run ``steps(k)`` for the first three steps; return (mean loss of each,
    first gradients by name, parameters' change by name)."""
    names = trainer._names
    p0 = [p.detach().clone() for p in trainer.model.parameters()]
    losses, grads = [], None
    for k in range(CHECK_STEPS):
        losses += [float(s["total loss"]) for s in steps(k)]
        if k == 0:
            # Adam's first moment after one step is (1 - b1) g
            grads = {n: m.detach() / (1.0 - ref.ADAM_B1)
                     for n, m in zip(names, trainer.optimizer.mu)}
    delta = {n: p.detach() - q for n, p, q in zip(names, trainer.model.parameters(), p0)}
    return losses, grads, delta


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        mode=None) -> Record:
    import torch

    from pmhc_tpu_torch.data.packed import DeviceDataset

    dev = torch.device(device)
    mode = mode or cell.config["mode"]
    tr = cell.traffic
    B, K = tr["batch"], tr["steps_per_dispatch"]
    rec = Record(cell)
    w = ref.make_weights(seed, dev)
    pool = make_pool(tr["entries"], seed)
    data = DeviceDataset(packed(pool), dev)
    trainer = make_trainer(cell, w, seed, dev, mode)
    rows = index_rows(seed, tr["entries"], B)
    first = np.stack([next(rows) for _ in range(CHECK_STEPS)])
    losses, grads, delta = readings(
        trainer, lambda k: trainer.train_indices(data, first[k:k + 1]))
    losses = [x / B for x in losses]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    def call():
        idx = np.stack([next(rows) for _ in range(K)])
        t = time.monotonic()
        with span("train_indices"):
            trainer.train_indices(data, idx)
        rec.spans.setdefault("dispatch", []).append((time.monotonic() - t) / K)

    call()
    sync()
    rec.spans.clear()

    def pump(duration):
        start, n = time.monotonic(), 0
        while time.monotonic() - start < duration:
            call()
            n += K
        sync()
        return n, time.monotonic() - start

    rec.setup_s = time.monotonic() - t0
    steps, rec.window_s = pump(seconds)
    rec.spans = {k: list(v) for k, v in rec.spans.items()}
    rec.completed = rec.attempted = steps * B
    rec.counters.update(steps=steps, batch=B)
    if trace:
        tracer = Tracer(dev)
        tracer.start()
        pump(tr["trace_seconds"])
        tracer.stop()
        rec.trace = tracer.trace
        rec.counters.update(busy_s=rec.trace.busy_s, trace_window_s=rec.trace.window_s)
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del trainer, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.checks = ref_check.check_training(
        w, pool, first, trainer_seed(seed), trainer_seed(seed) + 1, dev, losses, grads, delta,
        tr["lr"], cell.config["noise_step_count"])
    return rec
