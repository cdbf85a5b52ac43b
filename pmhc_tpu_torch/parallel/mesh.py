"""Meshes, this rank's share of a batch, and the tensor-parallel layout.

Counterpart of ``pmhc_tpu/parallel/mesh.py``. The JAX package builds one
``Mesh(('data', 'model', 'context'))`` over every device and annotates
arrays with ``NamedSharding``s; XLA then partitions the step. Here each
GPU is a process, and the mesh is a ``torch.distributed`` ``DeviceMesh``
over the group's ranks, in the same axis order:

- ``data`` splits the batch (DP): every rank of a data index holds its
  rows of the global batch (``shard_batch_spec``); parameters and
  optimizer state are replicated, broadcast from rank 0 (``replicate_``);
- ``model`` splits the MLPs' hidden width (TP): ``tp_param_shardings``
  gives each reference ``state_dict`` tensor its layout, and
  ``tp_shard_`` keeps only this rank's part;
- ``context`` splits the EGNN neighbour axis (CP,
  ``pmhc_tpu_torch.parallel.context``).

``batch_sharding`` and ``replicated_sharding`` name the layouts as
``torch.distributed.tensor`` placements, one per mesh axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.parallel.comm import gather_shards

AXES = ("data", "model", "context")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_context: int = 1) -> DeviceMesh:
    """A ``("data", "model", "context")`` ``DeviceMesh`` over ranks
    ``0 .. n_data * n_model * n_context - 1`` of the group, in that order
    (rank = (d * n_model + m) * n_context + c). ``n_data`` defaults to
    ``world // (n_model * n_context)`` (one at least). The mesh's device
    is the group's: ``"cuda"`` for NCCL, ``"cpu"`` for gloo. A mesh larger
    than the group raises; ranks outside a smaller one have no coordinate."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: initialize_multihost() first "
                           "(or start the ranks with torchrun)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = max(1, world // (n_model * n_context))
    n = n_data * n_model * n_context
    if n < 1 or n > world:
        raise ValueError(f"a mesh of {n_data} x {n_model} x {n_context} = {n} devices needs {n} "
                         f"processes; the group has {world}: start {n} ranks "
                         f"(torchrun --nproc-per-node {n})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n_data, n_model, n_context),
                      mesh_dim_names=AXES)


def batch_sharding(mesh: DeviceMesh):
    """The batch's layout: split on its leading axis over ``data``."""
    return (Shard(0), Replicate(), Replicate())


def replicated_sharding(mesh: DeviceMesh):
    return (Replicate(), Replicate(), Replicate())


def data_rows(mesh: DeviceMesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size``: the data axis's
    ``np.array_split`` of the rows; every rank needs one at least."""
    n = mesh.size(0)
    if batch_size < n:
        raise ValueError(f"a batch of {batch_size} cannot be split over {n} data ranks")
    d = mesh.get_coordinate()[0]
    base, extra = divmod(batch_size, n)
    start = d * base + min(d, extra)
    return slice(start, start + base + (d < extra))


def take_rows(batch: Mapping[str, Any], rows: slice) -> Dict[str, Any]:
    """``batch`` with every array, tensor, ``RigidArray`` and list cut to ``rows``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, RigidArray):
            out[k] = RigidArray(v.quats[rows], v.trans[rows])
        elif isinstance(v, (np.ndarray, torch.Tensor, list)):
            out[k] = v[rows]
        else:
            out[k] = v
    return out


def shard_batch_spec(batch: Mapping[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's rows of the global ``batch`` (``data_rows``)."""
    some = next(v for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)))
    return take_rows(batch, data_rows(mesh, len(some)))


@torch.no_grad()
def replicate_(tensors: Sequence[torch.Tensor], mesh: DeviceMesh) -> None:
    """The mesh's first rank's values of ``tensors`` on every rank of the
    mesh, in place: a flat buffer broadcast along ``context``, then
    ``model``, then ``data`` from each axis's index 0."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for axis in reversed(AXES):
        group = mesh.get_group(axis)
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in
                                   zip(torch.split(flat, [t.numel() for t in tensors]), tensors)])


def tp_shard_dim(name: str) -> Optional[int]:
    """The dimension a reference ``state_dict`` tensor is split on over
    ``model``, or None (replicated): an MLP's first Linear is
    column-parallel (weight ``[T, in]`` and bias on dim 0), its second
    row-parallel (weight ``[out, T]`` on dim 1, bias replicated)."""
    parts = name.split(".")
    if len(parts) < 3 or not parts[-3].endswith("_mlp"):
        return None
    if parts[-2] == "0":
        return 0
    if parts[-2] == "2" and parts[-1] == "weight":
        return 1
    return None


def tp_param_shardings(mesh: DeviceMesh, params) -> Dict[str, Any]:
    """Each tensor's placement on the ``model`` axis, by reference
    ``state_dict`` name (``params``: a module or a mapping of names):
    ``Shard(0)`` for ``<mlp>.0.weight`` / ``.0.bias``, ``Shard(1)`` for
    ``<mlp>.2.weight``, ``Replicate()`` else. These are torch's ``[out,
    in]`` transposes of the JAX package's ``P(None, 'model')`` (lin1.w),
    ``P('model')`` (lin1.b), ``P('model', None)`` (lin2.w) and ``P()``."""
    names = [n for n, _ in params.named_parameters()] if isinstance(params, nn.Module) \
        else list(params)
    out = {}
    for name in names:
        dim = tp_shard_dim(name)
        out[name] = Replicate() if dim is None else Shard(dim)
    return out


def _model_axis(mesh: DeviceMesh):
    return mesh.get_group("model"), mesh.size(1), mesh.get_local_rank("model")


@torch.no_grad()
def tp_shard_(model: nn.Module, mesh: DeviceMesh) -> None:
    """Keep this rank's part of every split tensor of ``model`` (in place:
    new ``Parameter``s) and set ``model.tp_mesh``, from which
    ``score_network_forward`` passes the ``model`` group to the layers
    (Megatron-style MLPs, ``models/nn.py``) or gathers whole weights for
    a kernel backend (``tp_full_params``)."""
    _, n, r = _model_axis(mesh)
    for name, p in list(model.named_parameters()):
        dim = tp_shard_dim(name)
        if dim is None:
            continue
        if p.shape[dim] % n:
            raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} not divisible by model={n}")
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf, nn.Parameter(p.chunk(n, dim)[r].clone()))
    model.tp_mesh = mesh


def _gather(tensors: List[torch.Tensor], dims: List[Optional[int]], mesh: DeviceMesh):
    """Full tensors from every ``model`` rank's parts (split on ``dims``;
    None: replicated, returned as is), in one all-gather."""
    group, n, _ = _model_axis(mesh)
    parts = [t for t, d in zip(tensors, dims) if d is not None]
    rows = gather_shards(torch.cat([t.reshape(-1) for t in parts]), group)
    out, off = [], 0
    for t, d in zip(tensors, dims):
        if d is None:
            out.append(t)
            continue
        k = t.numel()
        out.append(torch.cat([rows[i, off:off + k].view(t.shape) for i in range(n)], dim=d))
        off += k
    return out


def tp_full_params(model: nn.Module, mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """Every split parameter of ``model`` whole, differentiably: one
    all-gather; the gradient of each whole tensor reaches this rank as
    its part (the work after the gather is replicated over ``model``)."""
    named = [(n, p) for n, p in model.named_parameters() if tp_shard_dim(n) is not None]
    full = _gather([p for _, p in named], [tp_shard_dim(n) for n, _ in named], mesh)
    return {n: f for (n, _), f in zip(named, full)}


@torch.no_grad()
def tp_gather(names: Sequence[str], tensors: Sequence[torch.Tensor],
              mesh: DeviceMesh) -> List[torch.Tensor]:
    """Whole copies of the parts ``tensors`` of the reference tensors
    ``names`` (parameters or state that mirrors them: Adam moments, EMA)."""
    return [t.detach() for t in _gather(list(tensors), [tp_shard_dim(n) for n in names], mesh)]


def tp_take(names: Sequence[str], tensors: Sequence[torch.Tensor],
            mesh: DeviceMesh) -> List[torch.Tensor]:
    """This rank's parts of the whole tensors ``tensors`` named ``names``."""
    _, n, r = _model_axis(mesh)
    out = []
    for name, t in zip(names, tensors):
        d = tp_shard_dim(name)
        out.append(t if d is None else t.chunk(n, d)[r])
    return out
