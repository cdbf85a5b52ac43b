"""Full-state checkpoints with retention.

Counterpart of ``pmhc_tpu/train/checkpoints.py::CheckpointManager`` (the
Orbax manager): one file per step, ``<directory>/step_<step>.pt``,
written with ``torch.save`` (a state dict of tensors, generator states
and ints, so ``torch.load(weights_only=True)`` reads it back) and the
oldest removed beyond ``max_to_keep``. The reference-format ``.pth`` of
the weights alone is ``Trainer.save``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> str:
        """Write ``state`` for ``step`` (atomically) and drop the oldest
        checkpoints beyond ``max_to_keep``."""
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Dict[str, Any]:
        """The state saved for ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)
