"""Linear / 2-layer MLP helpers. Weights are torch ``[out, in]``.

Counterpart of ``pmhc_tpu/models/nn.py``. An MLP is the reference's
``nn.Sequential(Linear, ReLU, Linear)`` (so ``state_dict`` keys read
``<name>_mlp.0.weight`` / ``.2.weight``); a Linear over a concatenated
input is applied as block products (``linear_block``) so node terms never
expand across the neighbour grid.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def mlp(in_dim: int, hidden_dim: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(in_dim, hidden_dim), nn.ReLU(), nn.Linear(hidden_dim, out_dim)
    )


def init_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear's weight and bias from U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) — torch's default Linear init — from ``generator``."""
    with torch.no_grad():
        for lin in module.modules():
            if isinstance(lin, nn.Linear):
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                    p.copy_(u * (2.0 * bound) - bound)


def linear_block(lin: nn.Linear, x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``x @ W[start:start+size]`` for a Linear over a concatenated input
    (no bias): ``cat(a, b) @ W == a @ W_a + b @ W_b``."""
    return torch.matmul(x, lin.weight[:, start:start + size].T)


def mlp_hidden(seq: nn.Sequential, pre: torch.Tensor, final_sigmoid: bool = False) -> torch.Tensor:
    """Finish an MLP whose first-layer pre-activation the caller computed."""
    y = seq[2](torch.relu(pre))
    return torch.sigmoid(y) if final_sigmoid else y
