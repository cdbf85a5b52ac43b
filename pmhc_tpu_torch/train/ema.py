"""Exponential moving average of the parameters.

Counterpart of ``pmhc_tpu/train/ema.py::ema_of_params``: after each
optimizer update, ``ema = decay * ema + (1 - decay) * params``. The
average lives in the optimizer (``train.trainer.Adam``), so it is saved
and restored with its state.
"""

from __future__ import annotations

from typing import List

import torch


def ema_init(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """A copy of the parameters (the average starts at them)."""
    return [p.detach().clone() for p in params]


@torch.no_grad()
def ema_update_(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    """In place: ``ema = decay * ema + (1 - decay) * params``."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - decay)
