"""The score network: a 2-layer EGNN noise predictor.

Counterpart of ``pmhc_tpu/models/score.py``:
- node features = 22-dim sequence one-hot + a scalar time feature t/T
  (pocket nodes get 0 in the time slot);
- edge features = one-hot relative position over peptide pairs, zero
  toward the pocket; applied as a gather of first-layer weight rows
  (``relpos_edge_pre``), never as a one-hot tensor;
- layer 1: H=23 -> 64 features; ReLU; pocket features zero-padded 23->64;
  layer 2: 64 -> 1.

``ScoreNetworkConfig.backend`` picks the layer (``resolve_backend``; the
JAX package's names are accepted):

- ``"dense"`` (also ``"xla"``, the JAX package's default): the oracle layer
  of ``models/egnn.py``;
- ``"fused"`` (also ``"auto"``, ``"pallas_lane"``, ``"g8"``):
  ``score_network_forward`` runs the training layer
  (``ops/egnn_loop.py::egnn_forward_loop``: the neighbour-loop kernels with
  their hand-written backward), and ``diffusion/sampler.py`` runs the
  forward-only fused layer of ``ops/egnn_fused.py``;
- ``"pallas"``: the round-1 fused layer of ``ops/egnn_pallas.py`` (its
  kernel forward, the dense layer's autograd backward), fp32 only;
- ``"blockwise"``: the online-softmax layer over neighbour blocks of
  ``models/egnn_blockwise.py`` (plain PyTorch, autograd backward), fp32;
- ``"cp"`` / ``"ring"``: the context-parallel layers of
  ``parallel/context.py`` (plain PyTorch), their neighbour axis split over
  the ``context_group`` the caller passes (None: a group of one), fp32.

Under tensor parallelism (``parallel/mesh.py::tp_shard_``) the ``dense``,
``cp`` and ``ring`` layers compute each MLP Megatron-style on the split
weights; the kernel backends and ``blockwise`` take the whole weights,
gathered in one all-gather before the forward (``tp_full_params``), and
their gradients reach each rank as its part.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models.egnn import EGNNLayer, egnn_forward
from pmhc_tpu_torch.models.nn import init_uniform_

BACKENDS = {"dense": "dense", "xla": "dense", "fused": "fused", "auto": "fused",
            "pallas_lane": "fused", "g8": "fused", "pallas": "pallas", "blockwise": "blockwise",
            "cp": "cp", "ring": "ring"}
# the backends whose layers run Megatron-style on tensor-parallel parts
MEGATRON = ("dense", "cp", "ring")


def resolve_backend(name: str) -> str:
    """``"dense"``, ``"fused"``, ``"pallas"``, ``"blockwise"``, ``"cp"`` or
    ``"ring"`` for a backend name (the JAX package's names accepted)."""
    if name in BACKENDS:
        return BACKENDS[name]
    raise ValueError(f"unknown backend {name!r}: use one of {sorted(BACKENDS)}")


@dataclass(frozen=True)
class ScoreNetworkConfig:
    """Hyperparameters; defaults are the reference's hard-coded values."""

    max_len: int = 16  # peptide maxlen N
    node_input_size: int = 22  # sequence one-hot width
    noise_step_count: int = 1000  # T
    inner_size: int = 64  # features between the two layers
    message_size: int = 64  # M
    backend: str = "dense"
    neighbour_block: int = 32  # the blockwise backend's block of neighbours

    @property
    def relposenc_depth(self) -> int:
        return self.max_len * 2 - 1

    @property
    def node_feature_size(self) -> int:
        return self.node_input_size + 1  # + time feature


class ScoreNetwork(nn.Module):
    """``gnn1`` (H=23 -> 64) and ``gnn2`` (64 -> 1); 48 tensors, 79,195
    parameters at the default config. ``generator`` re-draws the weights
    from torch's default Linear init distribution, reproducibly."""

    def __init__(self, config: ScoreNetworkConfig = ScoreNetworkConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        H, E = config.node_feature_size, config.relposenc_depth
        self.gnn1 = EGNNLayer(H, E, config.inner_size, config.message_size)
        self.gnn2 = EGNNLayer(config.inner_size, E, 1, config.message_size)
        # the mesh whose ``model`` axis splits the MLP weights
        # (``parallel/mesh.py::tp_shard_``); None: whole weights
        self.tp_mesh = None
        if generator is not None:
            init_uniform_(self, generator)

    def forward(self, batch: Dict[str, Any], t, config: ScoreNetworkConfig, bf16=False,
                context_group=None) -> Dict[str, Any]:
        """``score_network_forward`` on this module's own tensors as they
        stand (no gather of tensor-parallel parts)."""
        return _forward(self, batch, t, config, bf16, context_group, None)


def relpos_edge_pre(layer: EGNNLayer, max_len: int) -> torch.Tensor:
    """``one_hot(relpos) @ W1[2H:]`` as a gather of the edge rows -> [N, N, T],
    at the relative-position index (N-1) + (i - j) in [0, 2N-2]. The index
    is built on the weights' device, with no copy from the host, so a CUDA
    graph can capture it."""
    w = layer.message_mlp[0].weight                   # [T, 2H+E]
    w_e = w[:, -(max_len * 2 - 1):].T                 # [E, T]
    r = torch.arange(max_len, device=w.device)
    return w_e[(max_len - 1) + (r[:, None] - r[None, :])]


def score_network_forward(
    model: ScoreNetwork,
    batch: Dict[str, Any],
    t,
    config: ScoreNetworkConfig,
    bf16=False,
    context_group=None,
) -> Dict[str, Any]:
    """Predict the noise on a batch of noised states, differentiably.

    ``batch``: ``frames`` (RigidArray [B, N]), ``torsions`` [B, N, 7, 2],
    ``features`` [B, N, 22], ``mask`` [B, N], ``pocket_frames`` (RigidArray
    [B, P]), ``pocket_mask`` [B, P], ``pocket_features`` [B, P, 22].
    ``t``: int, or a [B] tensor of per-sample timesteps. ``bf16`` selects
    the loop kernels' mode in the JAX package's convention
    (``pmhc_tpu/models/score.py``'s ``mm_mode``): True bf16, ``"high"``
    the ``--fast-f32`` split products, False fp32 (``"fused"`` backend
    only: the other backends run fp32 whatever it asks). ``context_group``: the process group the ``cp`` / ``ring``
    layers split the neighbour axis over (None: a group of one).
    Returns ``{"frames": RigidArray, "torsions": [B, N, 7, 2]}``.
    """
    mesh = model.tp_mesh
    if mesh is None:
        return _forward(model, batch, t, config, bf16, context_group, None)
    if resolve_backend(config.backend) in MEGATRON:
        # a model axis of one holds whole weights
        tp_group = mesh.get_group("model") if mesh.size(1) > 1 else None
        return _forward(model, batch, t, config, bf16, context_group, tp_group)
    from pmhc_tpu_torch.parallel.mesh import tp_full_params

    return torch.func.functional_call(model, tp_full_params(model, mesh),
                                      (batch, t, config, bf16, context_group))


def _forward(model: ScoreNetwork, batch: Dict[str, Any], t, config: ScoreNetworkConfig, bf16,
             context_group, tp_group) -> Dict[str, Any]:
    backend = resolve_backend(config.backend)
    if backend == "fused":
        from pmhc_tpu_torch.ops.egnn_loop import egnn_forward_loop

        def layer(*args):
            return egnn_forward_loop(*args, bf16=bf16)
    elif backend == "pallas":
        from pmhc_tpu_torch.ops.egnn_pallas import egnn_forward_pallas_trainable as layer
    elif backend == "blockwise":
        from pmhc_tpu_torch.models.egnn_blockwise import egnn_forward_blockwise

        def layer(*args):
            return egnn_forward_blockwise(*args, neighbour_block=config.neighbour_block)
    elif backend in ("cp", "ring"):
        from pmhc_tpu_torch.parallel.context import egnn_layer_cp

        def layer(*args):
            return egnn_layer_cp(*args, group=context_group, ring=backend == "ring",
                                 tp_group=tp_group)
    else:
        def layer(*args):
            return egnn_forward(*args, tp_group=tp_group)
    frames: RigidArray = batch["frames"]
    features = batch["features"]
    mask = batch["mask"].float()
    pocket_frames: RigidArray = batch["pocket_frames"]
    pocket_mask = batch["pocket_mask"].float()
    pocket_features = batch["pocket_features"]
    B, N = mask.shape
    P = pocket_mask.shape[-1]
    dev = features.device

    ft = torch.as_tensor(t, dtype=torch.float32, device=dev) / config.noise_step_count
    ft = torch.broadcast_to(ft.reshape(-1, 1, 1), (B, N, 1))
    h = torch.cat((features, ft), dim=-1)  # [B, N, 23]
    pocket_h = torch.cat(
        (pocket_features, torch.zeros((B, P, 1), dtype=torch.float32, device=dev)), dim=-1
    )

    edge_pre1 = relpos_edge_pre(model.gnn1, config.max_len)
    frames1, torsions1, inner = layer(
        model.gnn1, frames, batch["torsions"], h, edge_pre1, mask,
        pocket_h, pocket_frames, pocket_mask,
    )
    inner = torch.relu(inner)
    # pocket features zero-padded up to the inner width
    pocket_inner = nn.functional.pad(pocket_h, (0, config.inner_size - pocket_h.shape[-1]))

    edge_pre2 = relpos_edge_pre(model.gnn2, config.max_len)
    frames2, torsions2, _ = layer(
        model.gnn2, frames1, torsions1, inner, edge_pre2, mask,
        pocket_inner, pocket_frames, pocket_mask,
    )
    return {"frames": frames2, "torsions": torsions2}
