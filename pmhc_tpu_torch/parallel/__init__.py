"""Multi-GPU parallelism: one process per GPU, a ``("data", "model",
"context")`` mesh over them. Counterpart of ``pmhc_tpu/parallel`` (the
same public names): ``mesh`` (meshes, batch rows, the tensor-parallel
layout), ``distributed`` (process groups, ``spawn``), ``context`` (the
EGNN layer with its neighbour axis split over ``context``), ``comm``
(collectives with their backward)."""

from pmhc_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch_spec,
    tp_param_shardings,
)
from pmhc_tpu_torch.parallel.distributed import initialize_multihost, loader_shard_args
from pmhc_tpu_torch.parallel.context import (
    egnn_forward_cp,
    egnn_forward_ring,
    egnn_layer_cp,
)

__all__ = [
    "egnn_forward_cp",
    "egnn_forward_ring",
    "egnn_layer_cp",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch_spec",
    "tp_param_shardings",
    "initialize_multihost",
    "loader_shard_args",
]
