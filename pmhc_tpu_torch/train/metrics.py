"""Loss metrics summed on the device, written to a per-epoch CSV.

Counterpart of ``pmhc_tpu/train/metrics.py::MetricsRecord``: the train
step returns per-batch sums as device scalars; ``add_batch`` only keeps
them, and the one device-to-host copy happens in ``mean`` / ``save`` /
``has_nan``. The CSV is byte-compatible with the JAX package's (lazy
header, the reference's column order, 3-decimal rounding, append mode,
an existing file's header order honoured, a file with other columns
rotated aside).
"""

from __future__ import annotations

import csv
import logging
import math
import os
from typing import Dict

import torch

# the reference CSV's column order
_REFERENCE_ORDER = ("total loss", "positions loss", "rotations loss", "torsions loss", "rmsd")


class MetricsRecord:
    def __init__(self):
        self._pending = []    # batches not yet folded into the running totals
        self._running = None  # host-side running sums
        self._size = 0
        self._key_order = None

    def add_batch(self, batch_sums: Dict[str, torch.Tensor], batch_size: int) -> None:
        """Keep a train step's per-batch loss sums (no host sync)."""
        if self._key_order is None:
            self._key_order = [k for k in _REFERENCE_ORDER if k in batch_sums] + [
                k for k in batch_sums if k not in _REFERENCE_ORDER]
        self._pending.append(batch_sums)
        self._size += batch_size

    def _totals(self) -> Dict[str, float]:
        """Fold the pending batches into the running totals (one copy to
        the host for all of them)."""
        if self._pending:
            stacked = torch.stack([torch.stack([torch.as_tensor(b[k]).float().reshape(())
                                                for b in self._pending]).sum()
                                   for k in self._key_order])
            fresh = dict(zip(self._key_order, stacked.tolist()))
            if self._running is None:
                self._running = fresh
            else:
                self._running = {k: self._running[k] + fresh[k] for k in self._key_order}
            self._pending = []
        return dict(self._running) if self._running is not None else {}

    def mean(self) -> Dict[str, float]:
        return {k: v / self._size for k, v in self._totals().items()}

    def save(self, path: str, epoch_number: int) -> None:
        means = self.mean()
        keys = list(means.keys())
        add_header = not os.path.isfile(path)
        if not add_header:
            with open(path, "rt") as f:
                header = next(csv.reader(f), None)
            existing = [c for c in (header or []) if c != "epoch"]
            if existing and set(existing) == set(keys):
                keys = existing
            elif existing:
                old = path + ".old"
                n = 1
                while os.path.exists(old):
                    old = f"{path}.old.{n}"
                    n += 1
                logging.getLogger(__name__).warning(
                    "metrics CSV %s has columns %s but this run produces %s; rotating it to %s",
                    path, existing, keys, old)
                os.replace(path, old)
                add_header = True
        with open(path, "at") as f:
            w = csv.writer(f, delimiter=",")
            if add_header:
                w.writerow(["epoch"] + keys)
            w.writerow([epoch_number] + [round(means[k], 3) for k in keys])

    def __len__(self) -> int:
        """Number of examples accumulated (0 = nothing to save)."""
        return self._size

    def has_nan(self) -> bool:
        return any(math.isnan(v) for v in self._totals().values())
