"""E(n)-equivariant GNN layer over the fully connected peptide<->pocket graph.

Counterpart of ``pmhc_tpu/models/egnn.py::egnn_forward``: the dense
``[B, N, N+P, T]`` block-matmul layer. It is the port's in-package oracle
(backend ``"dense"``) that the fused kernel (``ops/egnn_fused.py``) is
held against.

Reference quirks preserved: the rotation MLP's sigmoid output is used
UNNORMALIZED as a quaternion delta; the softmax mask is a -1e9 additive
penalty, so fully masked rows get uniform weights; messages are summed
over ALL neighbours (masked included) for the feature update.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pmhc_tpu_torch.geometry import (
    RigidArray,
    multiply_sin_cos,
    quat_invert,
    quat_multiply,
    identity_quat,
    torch_normalize,
)
from pmhc_tpu_torch.models.nn import linear_block, mlp, mlp_hidden

INFINITY = 1e9  # softmax mask penalty
N_TORSIONS = 7
TRANSITION = 64  # hidden width of every MLP


class EGNNLayer(nn.Module):
    """The six 2-layer MLPs of one layer, named as the reference's
    ``EGNNLayer`` so ``state_dict`` keys match its checkpoints."""

    def __init__(self, node_input_size: int, edge_input_size: int,
                 node_output_size: int, message_size: int):
        super().__init__()
        H, M, T = node_input_size, message_size, TRANSITION
        self.feature_mlp = mlp(H + M, T, node_output_size)
        self.message_mlp = mlp(2 * H + edge_input_size, T, M)
        self.attention_mlp = mlp(M + 2, T, 1)
        self.translation_mlp = mlp(M, T, 1)
        self.rotation_mlp = mlp(M + 4, T, 4)
        self.torsion_mlp = mlp(M + N_TORSIONS * 2, T, N_TORSIONS)


def message_mask(peptide_mask: torch.Tensor, pocket_mask: torch.Tensor) -> torch.Tensor:
    """[B, N, N+P] float: peptide->peptide without self, peptide->pocket."""
    N = peptide_mask.shape[-1]
    pep = peptide_mask.float()
    pk = pocket_mask.float()
    not_self = 1.0 - torch.eye(N, dtype=torch.float32, device=pep.device)
    return torch.cat(
        (pep[:, :, None] * pep[:, None, :] * not_self, pep[:, :, None] * pk[:, None, :]),
        dim=-1,
    )


def egnn_forward(
    layer: EGNNLayer,
    peptide_frames: RigidArray,      # [B, N]
    peptide_torsions: torch.Tensor,  # [B, N, 7, 2]
    peptide_features: torch.Tensor,  # [B, N, H]
    edge_pre: torch.Tensor,          # [N, N, T] (see score.relpos_edge_pre)
    peptide_mask: torch.Tensor,      # [B, N] float {0, 1}
    pocket_features: torch.Tensor,   # [B, P, H]
    pocket_frames: RigidArray,       # [B, P]
    pocket_mask: torch.Tensor,       # [B, P] float {0, 1}
) -> Tuple[RigidArray, torch.Tensor, torch.Tensor]:
    """One message-passing round -> (frames, torsions, node features)."""
    B, N = peptide_mask.shape
    P = pocket_mask.shape[-1]
    H = peptide_features.shape[-1]
    M = layer.translation_mlp[0].in_features

    msg_mask = message_mask(peptide_mask, pocket_mask)  # [B, N, N+P]

    q_j = torch.cat((peptide_frames.quats, pocket_frames.quats), dim=-2)  # [B, N+P, 4]
    t_j = torch.cat((peptide_frames.trans, pocket_frames.trans), dim=-2)
    q_i = peptide_frames.quats
    t_i = peptide_frames.trans

    # message MLP: cat(h_i, h_j, e) @ W1 as block products
    mp = layer.message_mlp
    a_i = linear_block(mp[0], peptide_features, 0, H)              # [B, N, T]
    h_j = torch.cat((peptide_features, pocket_features), dim=-2)
    a_j = linear_block(mp[0], h_j, H, H)                            # [B, N+P, T]
    a_e = nn.functional.pad(edge_pre, (0, 0, 0, P))                 # [N, N+P, T]
    pre = a_i[:, :, None, :] + a_j[:, None, :, :] + a_e[None] + mp[0].bias
    message = mlp_hidden(mp, pre)                                   # [B, N, N+P, M]

    # attention
    d2 = torch.sum((t_i[:, :, None, :] - t_j[:, None, :, :]) ** 2, dim=-1)
    qdot2 = torch.sum(q_i[:, :, None, :] * q_j[:, None, :, :], dim=-1) ** 2
    ap = layer.attention_mlp
    att_pre = (
        linear_block(ap[0], message, 0, M)
        + (-d2)[..., None] * ap[0].weight[:, M]
        + qdot2[..., None] * ap[0].weight[:, M + 1]
        + ap[0].bias
    )
    att_logits = mlp_hidden(ap, att_pre)[..., 0] - (1.0 - msg_mask) * INFINITY
    weights = torch.softmax(att_logits, dim=-1)                     # [B, N, N+P]

    # feature update: message summed over ALL neighbours
    fp = layer.feature_mlp
    feat_pre = (
        linear_block(fp[0], peptide_features, 0, H)
        + linear_block(fp[0], torch.sum(message, dim=-2), H, M)
        + fp[0].bias
    )
    node_out = mlp_hidden(fp, feat_pre)

    # rotation update (sigmoid output used unnormalized)
    inv_q_j = quat_invert(q_j)[:, None]
    q_j_b = q_j[:, None]
    local_quats = quat_multiply(inv_q_j, quat_multiply(q_i[:, :, None], q_j_b))
    rp = layer.rotation_mlp
    rot_pre = (
        linear_block(rp[0], message, 0, M)
        + linear_block(rp[0], local_quats, M, 4)
        + rp[0].bias
    )
    local_delta = mlp_hidden(rp, rot_pre, final_sigmoid=True)
    global_delta = quat_multiply(q_j_b, quat_multiply(local_delta, inv_q_j))
    gd = torch.sum(global_delta * weights[..., None], dim=-2)
    has_neighbours = torch.sum(msg_mask, dim=-1) > 0.0
    gd = torch_normalize(torch.where(has_neighbours[..., None], gd, identity_quat(gd)))
    upd_q = quat_multiply(gd, q_i)

    # torsion update
    flat_torsions = peptide_torsions.reshape(B, N, N_TORSIONS * 2)
    tp = layer.torsion_mlp
    tor_pre = (
        linear_block(tp[0], message, 0, M)
        + linear_block(tp[0], flat_torsions, M, N_TORSIONS * 2)[:, :, None, :]
        + tp[0].bias
    )
    delta_a = torch.sum(mlp_hidden(tp, tor_pre) * weights[..., None], dim=-2)
    delta_t = torch.stack((torch.sin(delta_a), torch.cos(delta_a)), dim=-1)
    upd_torsions = multiply_sin_cos(delta_t, peptide_torsions)

    # translation update
    m = layer.translation_mlp(message)                              # [B, N, N+P, 1]
    r = t_i[:, :, None, :] - t_j[:, None, :, :]
    upd_x = t_i + torch.sum(m * r * weights[..., None], dim=-2)

    return RigidArray(torch_normalize(upd_q), upd_x), upd_torsions, node_out
