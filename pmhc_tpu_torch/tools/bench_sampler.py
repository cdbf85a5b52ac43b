"""Reverse-diffusion sampling throughput: samples/s of the full T-step chain.

The twin of the JAX package's ``tools/bench_sampler.py``. Per backend a
``SamplerService`` at ``--batch-size`` (the published-width network drawn
from seed 0) samples one batch (synthetic
entries from seed 0, start noise from a generator seeded 1) ``--iters``
times after a first call that builds the kernels and captures the chain's
CUDA graphs (``first_call_seconds``). Each call is timed from its dispatch
to a synchronize on the card's result: the chain alone, no PDB text.

    python -m pmhc_tpu_torch.tools.bench_sampler [--batch-size 64] [-T 1000] [--backends fused,pallas]

One JSON line per backend: ``samples_per_sec``, ``seconds_per_batch`` (the
mean), ``seconds`` (each call), ``first_call_seconds``, the precision that
ran, and the card's name and power limit.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser
from typing import Any, Dict, List

import torch

from pmhc_tpu_torch.tools import (BACKEND_CHOICES, card_line, make_entries, random_params,
                                  synchronize)


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch-size", "-b", type=int, default=64)
    p.add_argument("-T", type=int, default=1000)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--backends", default="fused,pallas",
                   help=f"comma list of {', '.join(BACKEND_CHOICES)}")
    p.add_argument("--sample-steps", type=int, default=None,
                   help="strided few-step sampling (default: full T)")
    p.add_argument("--bf16", action="store_true", help="bf16 mode of the fused kernel")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the fused kernel (products split into bf16 halves)")
    p.add_argument("--eager", action="store_true",
                   help="run the sampler eagerly instead of from CUDA graphs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    return p


def main(argv=None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    from pmhc_tpu_torch.models.score import resolve_backend
    from pmhc_tpu_torch.serve import SamplerService, resolve_device

    backends = args.backends.split(",")
    for b in backends:
        resolve_backend(b)  # a bad name fails before any work
    device = resolve_device(args.device)
    card = card_line(device)
    params = random_params()
    entries = make_entries("synthetic", args.batch_size, seed=0)
    rows = []
    for backend in backends:
        service = SamplerService(params, batch_size=args.batch_size, noise_step_count=args.T,
                                 num_steps=args.sample_steps, backend=backend, bf16=args.bf16,
                                 fast_f32=args.fast_f32, seed=0, device=device,
                                 graphs=False if args.eager else None)
        model_batch, _ = service.build_model_batch(
            entries, torch.Generator(device=device).manual_seed(1))

        def call(seed: int) -> float:
            synchronize(device)
            t0 = time.perf_counter()
            out = service.sample_model_batch(model_batch,
                                             torch.Generator(device=device).manual_seed(seed))
            synchronize(device)
            dt = time.perf_counter() - t0
            if not bool(torch.isfinite(out["frames"].trans).all()):
                raise RuntimeError(f"{backend}: non-finite samples")
            return dt

        first = call(2)
        seconds = [call(3 + i) for i in range(args.iters)]
        per_batch = sum(seconds) / len(seconds)
        row = {"backend": backend, "runs": service.backend, "precision": service.precision,
               "batch_size": args.batch_size, "T": args.T,
               "sample_steps": args.sample_steps or args.T, "graphs": service.graphs,
               "samples_per_sec": args.batch_size / per_batch, "seconds_per_batch": per_batch,
               "seconds": seconds, "first_call_seconds": first, "device": str(device),
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
