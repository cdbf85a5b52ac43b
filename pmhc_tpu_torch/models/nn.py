"""Linear / 2-layer MLP helpers. Weights are torch ``[out, in]``.

Counterpart of ``pmhc_tpu/models/nn.py``. An MLP is the reference's
``nn.Sequential(Linear, ReLU, Linear)`` (so ``state_dict`` keys read
``<name>_mlp.0.weight`` / ``.2.weight``); a Linear over a concatenated
input is applied as block products (``linear_block``) so node terms never
expand across the neighbour grid.

Tensor parallelism is asked for explicitly: the helpers take the
``model`` process group as ``group`` (None: whole weights, no
collective). With a group, an MLP's first Linear holds rows ``[T/n, in]``
of its weight and its second columns ``[out, T/n]``
(``parallel/mesh.py::tp_shard_``), and the MLP is computed Megatron-style:
a replicated input enters the column-parallel product through f
(``copy_to_group``) and the row-parallel product's partial outputs are
summed by g (``reduce_from_group``), one all-reduce an MLP.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
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


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x``; backward, the cotangents summed over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over ``group``; backward, the cotangent as is."""
    return _ReduceFromGroup.apply(x, group)


def linear_block(lin: nn.Linear, x: torch.Tensor, start: int, size: int,
                 group=None) -> torch.Tensor:
    """``x @ W[start:start+size]`` for a Linear over a concatenated input
    (no bias): ``cat(a, b) @ W == a @ W_a + b @ W_b``. With ``group``,
    ``lin`` is column-parallel and ``x`` enters through f."""
    if group is not None:
        x = copy_to_group(x, group)
    return torch.matmul(x, lin.weight[:, start:start + size].T)


def linear_column(lin: nn.Linear, x: torch.Tensor, col: int, group=None) -> torch.Tensor:
    """``x[..., None] * W[:, col]``: one scalar input column's term."""
    if group is not None:
        x = copy_to_group(x, group)
    return x[..., None] * lin.weight[:, col]


def mlp_hidden(seq: nn.Sequential, pre: torch.Tensor, final_sigmoid: bool = False,
               group=None) -> torch.Tensor:
    """Finish an MLP whose first-layer pre-activation the caller computed.
    With ``group``, the second Linear is row-parallel: g sums its partial
    products before the bias."""
    lin = seq[2]
    if group is None:
        y = lin(torch.relu(pre))
    else:
        y = reduce_from_group(nn.functional.linear(torch.relu(pre), lin.weight), group) + lin.bias
    return torch.sigmoid(y) if final_sigmoid else y


def mlp_apply(seq: nn.Sequential, x: torch.Tensor, group=None) -> torch.Tensor:
    """The whole MLP on ``x`` (Megatron-style with ``group``)."""
    if group is None:
        return seq(x)
    pre = linear_block(seq[0], x, 0, x.shape[-1], group) + seq[0].bias
    return mlp_hidden(seq, pre, group=group)
