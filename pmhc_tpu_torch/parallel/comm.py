"""Collectives that autograd can go through.

``torch.distributed``'s collectives have no gradient. The mesh paths need
these, each with its backward written out (Megatron's f and g around a
tensor-parallel MLP live with the MLP helpers, ``models/nn.py``):

- ``all_reduce_sum``: the context-parallel layer's partial sums over its
  neighbour blocks. Backward: an all-reduce of the cotangents. Work that is
  replicated over the group then gets per-rank cotangents whose mean is
  the true one, and rank-local work n times the true one, so the weight
  gradients are right once they are averaged over the group (the trainer
  does that in its one gradient all-reduce);
- ``ring_shift``: the ring's ``ppermute``, one hop forward round the group
  with ``batch_isend_irecv``; backward, the cotangents one hop back;
- ``gather_shards``: a tensor-parallel rank's flat shards from every rank
  of the group (all-gather); backward, this rank's part of the cotangent,
  for work replicated over the group after the gather.

Each takes ``group=None`` as a group of one (no collective).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; backward, the cotangents summed the same way."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Max over ``group``, no gradient (the softmax's stabilising max)."""
    x = x.detach().contiguous().clone()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent ``step`` ranks on round ``group``; the one ``step`` ranks
    back received."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    me = group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + step) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - step) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """One ring hop: rank i's ``x`` goes to rank i + 1 of ``group``."""
    return _RingShift.apply(x, group)


def all_gather_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """``[n, S]``: row r the 1-D ``flat`` of rank r of ``group`` (no gradient)."""
    n = group_size(group)
    out = flat.new_empty(n * flat.numel())
    if group is None:
        out.copy_(flat)
    else:
        # all_gather_single: all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, flat.detach().contiguous(), group=group)
    return out.view(n, -1)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        return all_gather_flat(flat, group)

    @staticmethod
    def backward(ctx, g):
        return g[group_rank(ctx.group)].clone(), None


def gather_shards(flat: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """``[n, S]``: row r the flat shards of rank r of ``group``; backward,
    row ``group_rank`` of the cotangent."""
    return _GatherShards.apply(flat, group)
