"""The port's evaluation and measurement tools: twins of the JAX package's
``tools/`` scripts, run as modules,

    python -m pmhc_tpu_torch.tools.eval_rmsd model.pth test.npz
    python -m pmhc_tpu_torch.tools.rmsd_backends model.pth
    python -m pmhc_tpu_torch.tools.bench_sampler
    python -m pmhc_tpu_torch.tools.bench_train
    python -m pmhc_tpu_torch.tools.bench_serve
    python -m pmhc_tpu_torch.tools.flops

Each runs on the card (``--device cuda``, the default) and takes the CPU
only when asked (``--device cpu``); without a card it raises. Each
``main(argv)`` returns what it printed (a dict, or a list of dicts), so a
caller can drive it in-process. The bench tools print one JSON line per
configuration with the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List

import numpy as np
import torch

# backend names the tools take: the port's own and the JAX package's
# (``models/score.py::resolve_backend``)
BACKEND_CHOICES = ("auto", "fused", "dense", "pallas", "xla", "pallas_lane", "g8")


def card_line(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them; ``"cpu"`` for a CPU device."""
    if torch.device("cuda" if device is None else device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def random_params() -> Dict[str, torch.Tensor]:
    """The published-width network drawn from seed 0 (a bench's time does
    not depend on the weights)."""
    from pmhc_tpu_torch.models import ScoreNetwork

    return ScoreNetwork(generator=torch.Generator().manual_seed(0)).state_dict()


def make_entries(kind: str, n: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """``n`` request entries with ground truth, built from ``seed``:
    ``realistic`` (``data/realistic.py``) or ``synthetic`` (``synthetic_batch``)."""
    from pmhc_tpu_torch.serve import ENTRY_SPECS, dummy_entry, entry_from_dataset

    if kind == "realistic":
        from pmhc_tpu_torch.data.realistic import realistic_packed

        ds = realistic_packed(n, seed)
        return [entry_from_dataset(ds, name) for name in ds.entry_names]
    from pmhc_tpu_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(batch_size=n, seed=seed)
    protein = {k: v for k, v in dummy_entry().items() if k.startswith("protein_")}
    return [{**{k: np.asarray(v[i]) for k, v in batch.items() if k in ENTRY_SPECS}, **protein}
            for i in range(n)]
