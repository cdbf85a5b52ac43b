"""Sampling quality: backbone RMSD of sampled peptides against the data's
ground-truth frames, with pure noise as the no-skill baseline.

The twin of the JAX package's ``tools/eval_rmsd.py``. Every entry of a
SwiftMHC HDF5 file or a packed ``.npz`` is sampled through the port's
sampler as the server samples it (``SamplerService``: batches padded to
``-b`` by repeating row 0, the chain from CUDA graphs on the card, batch
i drawing its start noise and its per-step noise from
``batch_generator(i)`` of a service seeded ``--seed``). Per entry: the
RMSD between the sampled and the true backbone translations over the
entry's real residues, and the same for the start noise (pure noise).

    python -m pmhc_tpu_torch.tools.eval_rmsd model.pth test.npz [-T 1000] [-b 16]

Prints one JSON document, the JAX tool's keys (``entries``, ``T``,
``sample_steps``, ``backend``, ``mean_backbone_rmsd``,
``mean_pure_noise_rmsd``, ``per_entry``) plus ``precision``, ``device``,
``card`` (name and power limit) and ``seconds`` (the whole sampling loop).
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser
from typing import Any, Dict, Optional, Sequence

import numpy as np

from pmhc_tpu_torch.tools import BACKEND_CHOICES, card_line


def masked_rmsd(pred_trans: np.ndarray, true_trans: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """RMSD over the real residues, per entry: sqrt(sum_mask |p - t|^2 / sum_mask)."""
    mask = np.asarray(mask, np.float64)
    sq = np.sum((np.asarray(pred_trans, np.float64) - true_trans) ** 2, axis=-1) * mask
    return np.sqrt(sq.sum(axis=-1) / mask.sum(axis=-1))


def sample_rows(service, entries: Sequence[Dict[str, np.ndarray]], generator,
                start: Optional[Dict[str, Any]] = None,
                injected_noise: Optional[Dict[str, Any]] = None):
    """Sample ``entries`` through ``service``; returns the sampled and the
    start (pure-noise) translations of the real rows, numpy ``[n, 16, 3]``.
    ``start`` (``gen_noise``'s form, the service's batch shape) replaces the
    start noise the generator drew; ``injected_noise`` the per-step noise."""
    model_batch, _ = service.build_model_batch(entries, generator)
    if start is not None:
        model_batch["frames"], model_batch["torsions"] = start["frames"], start["torsions"]
    n = len(entries)
    start_trans = model_batch["frames"].trans[:n].cpu().numpy()
    out = service.sample_model_batch(model_batch, generator, injected_noise)
    return out["frames"].trans[:n].cpu().numpy(), start_trans


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", help="model parameters: a .pth, or a checkpoint directory")
    p.add_argument("data", help="entries with ground truth: SwiftMHC HDF5, or a packed .npz")
    p.add_argument("-T", type=int, default=1000, help="number of noise steps")
    p.add_argument("--batch-size", "-b", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-steps", type=int, default=None,
                   help="strided few-step sampling (default: full T)")
    p.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                   help="auto / fused / pallas_lane / g8: the fused kernel; pallas: the "
                        "round-1 fused kernel (fp32 only); dense / xla: the dense layer")
    p.add_argument("--bf16", action="store_true", help="bf16 mode of the fused kernel")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the fused kernel (products split into bf16 halves)")
    p.add_argument("--eager", action="store_true",
                   help="run the sampler eagerly instead of from CUDA graphs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    return p


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    from pmhc_tpu_torch.data.packed import open_dataset
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.serve import SamplerService, entry_from_dataset

    service = SamplerService(load_params(args.model), batch_size=args.batch_size,
                             noise_step_count=args.T, num_steps=args.sample_steps,
                             backend=args.backend, bf16=args.bf16, fast_f32=args.fast_f32,
                             seed=args.seed, device=args.device,
                             graphs=False if args.eager else None)
    dataset = open_dataset(args.data)
    names = list(dataset.entry_names)

    rmsds, noise_rmsds = [], []
    t0 = time.monotonic()
    for i in range(0, len(names), args.batch_size):
        entries = [entry_from_dataset(dataset, n) for n in names[i:i + args.batch_size]]
        pred, start = sample_rows(service, entries, service.batch_generator(i // args.batch_size))
        true = np.stack([e["frames"][..., 4:] for e in entries])
        mask = np.stack([e["mask"] for e in entries])
        rmsds.extend(masked_rmsd(pred, true, mask).tolist())
        noise_rmsds.extend(masked_rmsd(start, true, mask).tolist())
    seconds = time.monotonic() - t0

    report = {
        "entries": len(names),
        "T": args.T,
        "sample_steps": args.sample_steps or args.T,
        "backend": f"{service.backend} {service.precision}",
        "precision": service.precision,
        "mean_backbone_rmsd": float(np.mean(rmsds)),
        "mean_pure_noise_rmsd": float(np.mean(noise_rmsds)),
        "per_entry": dict(zip(names, rmsds)),
        "seconds": seconds,
        "device": str(service.device),
        "card": card_line(service.device),
    }
    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
