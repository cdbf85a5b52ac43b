"""The EGNN layer over neighbour blocks with an online (flash-style) softmax.

Counterpart of ``pmhc_tpu/models/egnn_blockwise.py::egnn_forward_blockwise``
(backend ``"blockwise"``), in plain PyTorch: the JAX function reaches no
Pallas kernel. The dense layer (``models/egnn.py``) builds [B, N, N+P, *]
tensors; this one walks the neighbour axis in blocks of
``neighbour_block`` and keeps only [B, N, block, *] of them live, with a
running softmax state per query node: the max, the denominator, and one
concatenated numerator for the attention-weighted sums (4 rotation, 7
torsion and 3 translation channels share the weights), plus the plain
message sum of the feature update. Each new block rescales the state by
exp(m_old - m_new) before adding its own terms. The output equals
``egnn_forward``'s to fp32 tolerance. It trains through autograd over the
block loop, as the JAX function trains through ``jax.grad`` of its scan.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pmhc_tpu_torch.geometry import (
    RigidArray,
    identity_quat,
    multiply_sin_cos,
    quat_invert,
    quat_multiply,
    torch_normalize,
)
from pmhc_tpu_torch.models.egnn import INFINITY, N_TORSIONS, EGNNLayer, message_mask
from pmhc_tpu_torch.models.nn import linear_block, mlp_hidden


def egnn_forward_blockwise(
    layer: EGNNLayer,
    peptide_frames: RigidArray,      # [B, N]
    peptide_torsions: torch.Tensor,  # [B, N, 7, 2]
    peptide_features: torch.Tensor,  # [B, N, H]
    edge_pre: torch.Tensor,          # [N, N, T]
    peptide_mask: torch.Tensor,      # [B, N] float {0, 1}
    pocket_features: torch.Tensor,   # [B, P, H]
    pocket_frames: RigidArray,       # [B, P]
    pocket_mask: torch.Tensor,       # [B, P] float {0, 1}
    neighbour_block: int = 32,
) -> Tuple[RigidArray, torch.Tensor, torch.Tensor]:
    """Drop-in equivalent of ``egnn_forward`` with O(block) neighbour
    memory. N+P must be divisible by ``neighbour_block`` (else ValueError)."""
    B, N = peptide_mask.shape
    P = pocket_mask.shape[-1]
    NP = N + P
    H = peptide_features.shape[-1]
    M = layer.translation_mlp[0].in_features
    if NP % neighbour_block:
        raise ValueError(f"egnn_forward_blockwise: N+P = {NP} is not divisible by "
                         f"neighbour_block = {neighbour_block}")

    msg_mask = message_mask(peptide_mask, pocket_mask)  # [B, N, NP]
    h_all = torch.cat((peptide_features, pocket_features), dim=-2)
    q_all = torch.cat((peptide_frames.quats, pocket_frames.quats), dim=-2)
    t_all = torch.cat((peptide_frames.trans, pocket_frames.trans), dim=-2)
    edge_full = nn.functional.pad(edge_pre, (0, 0, 0, P))  # [N, NP, T]
    q_i, t_i = peptide_frames.quats, peptide_frames.trans

    mp, ap, rp, tp, lp, fp = (layer.message_mlp, layer.attention_mlp, layer.rotation_mlp,
                              layer.torsion_mlp, layer.translation_mlp, layer.feature_mlp)
    a_i = linear_block(mp[0], peptide_features, 0, H)  # [B, N, T]
    flat_torsions = peptide_torsions.reshape(B, N, N_TORSIONS * 2)
    tor_node = linear_block(tp[0], flat_torsions, M, N_TORSIONS * 2)

    # running state: softmax max and denominator, the weighted numerators
    # (C = 4 rot + 7 tor + 3 trans channels) and the plain message sum
    C = 4 + N_TORSIONS + 3
    dev = peptide_features.device
    m_run = torch.full((B, N), -torch.inf, device=dev)
    l_run = torch.zeros((B, N), device=dev)
    num_run = torch.zeros((B, N, C), device=dev)
    msg_sum = torch.zeros((B, N, M), device=dev)

    for lo in range(0, NP, neighbour_block):
        hi = lo + neighbour_block
        h_j, q_j, t_j = h_all[:, lo:hi], q_all[:, lo:hi], t_all[:, lo:hi]
        mask_b = msg_mask[..., lo:hi]

        pre = (a_i[:, :, None, :] + linear_block(mp[0], h_j, H, H)[:, None, :, :]
               + edge_full[None, :, lo:hi] + mp[0].bias)
        message = mlp_hidden(mp, pre)  # [B, N, nb, M]
        msg_sum = msg_sum + torch.sum(message, dim=-2)

        d2 = torch.sum((t_i[:, :, None, :] - t_j[:, None, :, :]) ** 2, dim=-1)
        qdot2 = torch.sum(q_i[:, :, None, :] * q_j[:, None, :, :], dim=-1) ** 2
        att_pre = (linear_block(ap[0], message, 0, M)
                   + (-d2)[..., None] * ap[0].weight[:, M]
                   + qdot2[..., None] * ap[0].weight[:, M + 1]
                   + ap[0].bias)
        logits = mlp_hidden(ap, att_pre)[..., 0] - (1.0 - mask_b) * INFINITY  # [B, N, nb]

        # the block's weighted values
        inv_q_j = quat_invert(q_j)[:, None]
        q_j_b = q_j[:, None]
        local_quats = quat_multiply(inv_q_j, quat_multiply(q_i[:, :, None], q_j_b))
        rot_pre = (linear_block(rp[0], message, 0, M) + linear_block(rp[0], local_quats, M, 4)
                   + rp[0].bias)
        local_delta = mlp_hidden(rp, rot_pre, final_sigmoid=True)
        global_delta = quat_multiply(q_j_b, quat_multiply(local_delta, inv_q_j))
        tor_pre = linear_block(tp[0], message, 0, M) + tor_node[:, :, None, :] + tp[0].bias
        m_delta_a = mlp_hidden(tp, tor_pre)  # [B, N, nb, 7]
        m_tr = lp(message)  # [B, N, nb, 1]
        r = t_i[:, :, None, :] - t_j[:, None, :, :]
        values = torch.cat((global_delta, m_delta_a, m_tr * r), dim=-1)

        # online softmax update
        m_new = torch.maximum(m_run, torch.amax(logits, dim=-1))
        rescale = torch.exp(m_run - m_new)
        expw = torch.exp(logits - m_new[..., None])
        l_run = l_run * rescale + torch.sum(expw, dim=-1)
        num_run = num_run * rescale[..., None] + torch.sum(expw[..., None] * values, dim=-2)
        m_run = m_new

    weighted = num_run / l_run[..., None]  # [B, N, C]

    # feature update: message summed over all neighbours
    feat_pre = (linear_block(fp[0], peptide_features, 0, H) + linear_block(fp[0], msg_sum, H, M)
                + fp[0].bias)
    node_out = mlp_hidden(fp, feat_pre)

    # rotation update
    gd = weighted[..., :4]
    has_neighbours = torch.sum(msg_mask, dim=-1) > 0.0
    gd = torch_normalize(torch.where(has_neighbours[..., None], gd, identity_quat(gd)))
    upd_q = quat_multiply(gd, q_i)

    # torsion update
    delta_a = weighted[..., 4:4 + N_TORSIONS]
    delta_t = torch.stack((torch.sin(delta_a), torch.cos(delta_a)), dim=-1)
    upd_torsions = multiply_sin_cos(delta_t, peptide_torsions)

    # translation update
    upd_x = t_i + weighted[..., 4 + N_TORSIONS:]

    return RigidArray(torch_normalize(upd_q), upd_x), upd_torsions, node_out
