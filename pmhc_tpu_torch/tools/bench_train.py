"""Training throughput: steps/s and examples/s of the graphed ``Trainer``.

The twin of the JAX package's ``tools/bench_train.py`` (its scan-amortised
step on device-resident batches). The data lives on the device (a
``DeviceDataset`` of one batch's worth of realistic entries); each
dispatch is one ``Trainer.train_indices`` call of ``--steps-per-dispatch``
K steps, each step one replay of a CUDA graph that gathers its batch (a
fixed random draw of the entries) on the card. After one warm-up
dispatch (it builds the kernels and captures the step), ``--repeats``
windows of ``--iters`` dispatches are timed, a synchronize closing each
window; the best window is reported.

    python -m pmhc_tpu_torch.tools.bench_train [--batches 64,1024] [--backends fused,pallas] [--bf16]

One JSON line per (batch, backend): ``steps_per_sec``,
``examples_per_sec``, every window's steps/s, the precision that ran and
the card's name and power limit. A config that fails prints a ``FAILED``
line with its error, the others still run, and the run exits 1.
"""

from __future__ import annotations

import json
import time
import traceback
from argparse import ArgumentParser
from typing import Any, Dict, List

import numpy as np

from pmhc_tpu_torch.tools import BACKEND_CHOICES, card_line, synchronize


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default="64", help="comma list of batch sizes (e.g. 64,1024)")
    p.add_argument("--backends", default="fused,pallas",
                   help=f"comma list of {', '.join(BACKEND_CHOICES)}")
    p.add_argument("-T", type=int, default=1000, help="number of noise steps")
    p.add_argument("--steps-per-dispatch", type=int, default=20,
                   help="K: steps per train_indices call")
    p.add_argument("--iters", type=int, default=3, help="dispatches per timed window")
    p.add_argument("--repeats", type=int, default=3, help="timed windows (the best is reported)")
    p.add_argument("--bf16", action="store_true", help="bf16 mode of the loop kernels")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the loop kernels (products split into bf16 halves)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    return p


def bench(args, data, B: int, backend: str, device, card: str) -> Dict[str, Any]:
    from pmhc_tpu_torch.diffusion import DiffusionConfig
    from pmhc_tpu_torch.models import ScoreNetworkConfig
    from pmhc_tpu_torch.models.score import resolve_backend
    from pmhc_tpu_torch.train import TrainConfig, Trainer

    trainer = Trainer(ScoreNetworkConfig(noise_step_count=args.T, backend=resolve_backend(backend)),
                      DiffusionConfig(noise_step_count=args.T), TrainConfig(seed=0, batch_size=B),
                      bf16=args.bf16, fast_f32=args.fast_f32, device=device)
    K = args.steps_per_dispatch
    idx = np.random.default_rng(0).integers(0, len(data), size=(K, B))
    trainer.train_indices(data, idx)  # warm-up: builds the kernels, captures the step
    synchronize(device)
    sums = None
    windows = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            sums = trainer.train_indices(data, idx)
        synchronize(device)
        windows.append(args.iters * K / (time.perf_counter() - t0))
    loss = float(sums[-1]["total loss"]) / B
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    best = max(windows)
    return {"batch_size": B, "backend": backend, "precision": trainer.precision,
            "steps_per_sec": best, "examples_per_sec": best * B, "windows_steps_per_sec": windows,
            "steps_per_dispatch": K, "iters": args.iters, "graphs": trainer.graphs,
            "steps": (1 + args.repeats * args.iters) * K, "last_loss": loss,
            "device": str(device), "card": card}


def main(argv=None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    from pmhc_tpu_torch.data import DeviceDataset
    from pmhc_tpu_torch.data.realistic import realistic_packed
    from pmhc_tpu_torch.serve import resolve_device

    device = resolve_device(args.device)
    card = card_line(device)
    rows, failed = [], []
    for B in (int(b) for b in args.batches.split(",")):
        # one batch's worth of entries; each step gathers a random draw of them
        data = DeviceDataset(realistic_packed(B, seed=0), device)
        for backend in args.backends.split(","):
            try:
                row = bench(args, data, B, backend, device, card)
            except Exception as e:  # noqa: BLE001 — reported, and the run exits 1
                traceback.print_exc()
                failed.append(f"batch {B} {backend}")
                print(f"batch {B} {backend}: FAILED {type(e).__name__}: {e}", flush=True)
                continue
            rows.append(row)
            print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit(f"bench_train: {len(failed)} config(s) failed: {failed}")
    return rows


if __name__ == "__main__":
    main()
