"""Cross-backend and cross-precision agreement of the sampling distribution.

The twin of the JAX package's ``tools/rmsd_backends.py``. Single
trajectories of two backends drift apart (the reverse chain amplifies
float summation order), which is fine if their sampling distributions
agree. Every ``backend:precision`` of ``--configs`` samples the same
entries from the same start noise (drawn once from ``--seed + 1``) with
the same per-step noise generator (seeded ``--seed + 2`` afresh for each
config), and each config's mean backbone RMSD is held against the first's
at ``--rtol``.

    python -m pmhc_tpu_torch.tools.rmsd_backends model.pth [-T 200] [--entries 16]

Entries are built from ``--seed`` (``--data realistic``: the
``data/realistic.py`` generator; ``synthetic``: ``synthetic_batch``). One
JSON line per config, then the verdict line; a mismatch exits 1.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser
from typing import Any, Dict, List

import numpy as np
import torch

from pmhc_tpu_torch.tools import card_line, make_entries, synchronize
from pmhc_tpu_torch.tools.eval_rmsd import masked_rmsd, sample_rows

PRECISIONS = ("fp32", "bf16", "fast-f32")


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", help="model parameters: a .pth, or a checkpoint directory")
    p.add_argument("-T", type=int, default=200, help="number of noise steps")
    p.add_argument("--entries", type=int, default=16)
    p.add_argument("--data", default="synthetic", choices=("synthetic", "realistic"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rtol", type=float, default=0.1,
                   help="relative tolerance on each mean RMSD against the first config's")
    p.add_argument("--configs", default="dense:fp32,fused:fp32,fused:bf16,fused:fast-f32,pallas:fp32",
                   help="backend:precision pairs (precision: fp32, bf16, fast-f32)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    return p


def parse_configs(spec: str) -> List[tuple]:
    """``"fused:bf16,..."`` -> ``[("fused", "bf16"), ...]``; raises on a bad pair."""
    from pmhc_tpu_torch.models.score import resolve_backend

    out = []
    for item in spec.split(","):
        backend, _, prec = item.partition(":")
        resolve_backend(backend)
        if prec not in PRECISIONS:
            raise ValueError(f"config {item!r}: precision must be one of {PRECISIONS}")
        out.append((backend, prec))
    return out


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.serve import SamplerService, resolve_device

    configs = parse_configs(args.configs)
    device = resolve_device(args.device)
    card = card_line(device)
    params = load_params(args.model)
    entries = make_entries(args.data, args.entries, args.seed)
    true = np.stack([e["frames"][..., 4:] for e in entries])
    mask = np.stack([e["mask"] for e in entries])
    start = gen_noise(torch.Generator(device=device).manual_seed(args.seed + 1),
                      (len(entries), true.shape[1]), DiffusionConfig(noise_step_count=args.T))

    rows, baseline, failures = [], None, []
    for backend, prec in configs:
        service = SamplerService(params, batch_size=len(entries), noise_step_count=args.T,
                                 backend=backend, bf16=prec == "bf16", fast_f32=prec == "fast-f32",
                                 seed=args.seed, device=device)
        t0 = time.monotonic()
        pred, _ = sample_rows(service, entries,
                              torch.Generator(device=device).manual_seed(args.seed + 2), start)
        synchronize(device)
        r = masked_rmsd(pred, true, mask)
        row = {"backend": backend, "precision": prec, "runs": service.precision,
               "rmsd_mean": float(r.mean()), "rmsd_std": float(r.std()),
               "rmsd_max": float(r.max()),
               "seconds": time.monotonic() - t0, "T": args.T, "entries": len(entries),
               "card": card}
        if baseline is None:
            baseline = row["rmsd_mean"]
            row["role"] = "baseline"
        else:
            rel = abs(row["rmsd_mean"] - baseline) / baseline
            row["rel_gap_vs_baseline"] = rel
            row["ok"] = bool(rel <= args.rtol)
            if not row["ok"]:
                failures.append(f"{backend}:{prec}")
        rows.append(row)
        print(json.dumps(row), flush=True)

    verdict = {"verdict": "MISMATCH" if failures else "MATCH", "rtol": args.rtol,
               "failures": failures}
    print(json.dumps(verdict), flush=True)
    return {"rows": rows, **verdict}


def cli(argv=None) -> None:
    """``main``, exiting 1 on a mismatch."""
    if main(argv)["failures"]:
        raise SystemExit(1)


if __name__ == "__main__":
    cli()
