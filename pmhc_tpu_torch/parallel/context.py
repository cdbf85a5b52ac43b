"""Context parallelism: the EGNN neighbour axis split over a process group.

Counterpart of ``pmhc_tpu/parallel/context.py``. The JAX package runs
these layers inside ``shard_map`` and names the mesh axis; here each takes
the ``context`` process group (``group=None``: a group of one, no
collective). Each rank holds a slice of the N + P neighbours, and the
attention softmax and its four weighted sums are computed in two passes:

  pass 1: local max -> all-reduce MAX over the group (no gradient: the
          shift cancels in the softmax; JAX's ``stop_gradient``)
  pass 2: local sums of exp(logit - global max) and of exp * {rotation
          deltas, torsion deltas, translation terms}, the plain message
          sum and the neighbour count -> one all-reduce of one buffer

``egnn_forward_ring`` is the streaming variant: the neighbour blocks stay
where they are and the query slices travel the ring (``comm.ring_shift``,
``batch_isend_irecv``) with their online-softmax state (running max,
denominator, three numerators, message sum), rescaled flash-style at
every hop; after ``n`` hops each slice is home. Its running max carries
no gradient either (the same cancellation).

Gradients: an all-reduce's backward is an all-reduce of the cotangents
(``comm.all_reduce_sum``), so the weight gradients are right once averaged
over the group, which the trainer's gradient all-reduce does. The layer
is plain PyTorch, as in JAX, where it reaches no ``pl.pallas_call``. Its
MLPs run Megatron-style when the caller passes the ``model`` group its
weights are split over (``tp_group``, ``models/nn.py``), which is how the
port computes DP x TP x CP.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.nn import functional as F

from pmhc_tpu_torch.geometry import (
    RigidArray,
    identity_quat,
    multiply_sin_cos,
    quat_invert,
    quat_multiply,
    torch_normalize,
)
from pmhc_tpu_torch.models.egnn import EGNNLayer, message_mask
from pmhc_tpu_torch.models.nn import linear_block, linear_column, mlp_apply, mlp_hidden
from pmhc_tpu_torch.parallel.comm import (
    all_reduce_max,
    all_reduce_sum,
    group_rank,
    group_size,
    ring_shift,
)

INFINITY = 1e9
N_TORSIONS = 7


def _block_terms(layer: EGNNLayer, q_i, t_i, h_i, flat_torsions, q_j, t_j, h_j, edge_blk, mask,
                 tp_group):
    """A query slice [B, Nq, *] against a neighbour block [B, NPs, *]:
    masked attention logits, messages, and the three per-edge values the
    softmax weights (global rotation deltas, torsion deltas, translation
    terms). ``edge_blk`` [Nq, NPs, T], ``mask`` [B, Nq, NPs]."""
    H = h_i.shape[-1]
    M = layer.translation_mlp[0].in_features

    mp = layer.message_mlp
    a_i = linear_block(mp[0], h_i, 0, H, tp_group)
    a_j = linear_block(mp[0], h_j, H, H, tp_group)
    pre = a_i[:, :, None, :] + a_j[:, None, :, :] + edge_blk[None] + mp[0].bias
    message = mlp_hidden(mp, pre, group=tp_group)

    d2 = torch.sum((t_i[:, :, None, :] - t_j[:, None, :, :]) ** 2, dim=-1)
    qdot2 = torch.sum(q_i[:, :, None, :] * q_j[:, None, :, :], dim=-1) ** 2
    ap = layer.attention_mlp
    att_pre = (linear_block(ap[0], message, 0, M, tp_group)
               + linear_column(ap[0], -d2, M, tp_group)
               + linear_column(ap[0], qdot2, M + 1, tp_group) + ap[0].bias)
    logits = mlp_hidden(ap, att_pre, group=tp_group)[..., 0] - (1.0 - mask) * INFINITY

    inv_q_j = quat_invert(q_j)[:, None]
    q_j_b = q_j[:, None]
    local_quats = quat_multiply(inv_q_j, quat_multiply(q_i[:, :, None], q_j_b))
    rp = layer.rotation_mlp
    rot_pre = (linear_block(rp[0], message, 0, M, tp_group)
               + linear_block(rp[0], local_quats, M, 4, tp_group) + rp[0].bias)
    local_delta = mlp_hidden(rp, rot_pre, final_sigmoid=True, group=tp_group)
    global_delta = quat_multiply(q_j_b, quat_multiply(local_delta, inv_q_j))

    tp = layer.torsion_mlp
    tor_pre = (linear_block(tp[0], message, 0, M, tp_group)
               + linear_block(tp[0], flat_torsions, M, N_TORSIONS * 2, tp_group)[:, :, None, :]
               + tp[0].bias)
    m_delta_a = mlp_hidden(tp, tor_pre, group=tp_group)

    m = mlp_apply(layer.translation_mlp, message, tp_group)  # [B, Nq, NPs, 1]
    mr = m * (t_i[:, :, None, :] - t_j[:, None, :, :])
    return logits, message, global_delta, m_delta_a, mr


def _finalize(layer: EGNNLayer, h_i, torsions, q_i, t_i, msg_sum, gd, delta_a, tr, has_nb,
              tp_group):
    """The softmax-weighted sums to the layer's outputs (feature MLP,
    quaternion, torsion and translation updates), as the dense layer."""
    H = h_i.shape[-1]
    M = msg_sum.shape[-1]
    fp = layer.feature_mlp
    feat_pre = (linear_block(fp[0], h_i, 0, H, tp_group)
                + linear_block(fp[0], msg_sum, H, M, tp_group) + fp[0].bias)
    node_out = mlp_hidden(fp, feat_pre, group=tp_group)

    gd = torch_normalize(torch.where(has_nb[..., None], gd, identity_quat(gd)))
    upd_q = quat_multiply(gd, q_i)
    delta_t = torch.stack((torch.sin(delta_a), torch.cos(delta_a)), dim=-1)
    upd_torsions = multiply_sin_cos(delta_t, torsions)
    return RigidArray(torch_normalize(upd_q), t_i + tr), upd_torsions, node_out


def egnn_layer_cp(
    layer: EGNNLayer,
    peptide_frames: RigidArray,      # [B, N] (the same on every rank of the group)
    peptide_torsions: torch.Tensor,  # [B, N, 7, 2]
    peptide_features: torch.Tensor,  # [B, N, H]
    edge_pre: torch.Tensor,          # [N, N, T]
    peptide_mask: torch.Tensor,      # [B, N]
    pocket_features: torch.Tensor,   # [B, P, H]
    pocket_frames: RigidArray,       # [B, P]
    pocket_mask: torch.Tensor,       # [B, P]
    group=None,
    ring: bool = False,
    tp_group=None,
) -> Tuple[RigidArray, torch.Tensor, torch.Tensor]:
    """The dense layer ``models/egnn.py::egnn_forward`` (same arguments,
    same outputs, on every rank) with its neighbour axis split over
    ``group``: inputs arrive whole on every rank, and each slices its own
    neighbour block. ``ring=False``: ``egnn_forward_cp``; ``ring=True``:
    ``egnn_forward_ring``, the queries split too, outputs gathered back to
    full N. N + P (and for the ring N) must divide by the group's size.
    ``tp_group``: the ``model`` group the MLP weights are split over
    (``models/nn.py``; None: whole weights)."""
    B, N = peptide_mask.shape
    Pk = pocket_mask.shape[-1]
    NP = N + Pk
    n, idx = group_size(group), group_rank(group)
    if NP % n:
        raise ValueError(f"neighbour axis {NP} not divisible by cp={n}")

    h_all = torch.cat((peptide_features, pocket_features), dim=-2)
    q_all = torch.cat((peptide_frames.quats, pocket_frames.quats), dim=-2)
    t_all = torch.cat((peptide_frames.trans, pocket_frames.trans), dim=-2)
    msg_mask = message_mask(peptide_mask, pocket_mask)  # [B, N, NP]
    edge_full = F.pad(edge_pre, (0, 0, 0, Pk))         # [N, NP, T]

    NPs = NP // n
    nb = slice(idx * NPs, (idx + 1) * NPs)
    nbr_frames = RigidArray(q_all[:, nb], t_all[:, nb])
    nbr_h, e_shard, m_shard = h_all[:, nb], edge_full[:, nb], msg_mask[:, :, nb]

    if not ring:
        return egnn_forward_cp(layer, peptide_frames, peptide_torsions, peptide_features,
                               e_shard, m_shard, nbr_h, nbr_frames, group, tp_group)

    if N % n:
        raise ValueError(f"query axis {N} not divisible by cp={n} (ring)")
    Ns = N // n
    qs = slice(idx * Ns, (idx + 1) * Ns)
    out_f, out_t, out_h = egnn_forward_ring(
        layer, RigidArray(peptide_frames.quats[:, qs], peptide_frames.trans[:, qs]),
        peptide_torsions[:, qs], peptide_features[:, qs], e_shard, m_shard, nbr_h, nbr_frames,
        group, tp_group)

    def gather(x):
        # the disjoint query slices summed into place: an all-gather whose
        # backward is the layer's all-reduce
        pad = [0, 0] * (x.dim() - 2) + [idx * Ns, N - (idx + 1) * Ns]
        return all_reduce_sum(F.pad(x, pad), group)

    return RigidArray(gather(out_f.quats), gather(out_f.trans)), gather(out_t), gather(out_h)


def egnn_forward_cp(
    layer: EGNNLayer,
    peptide_frames: RigidArray,       # [B, N] (whole on every rank)
    peptide_torsions: torch.Tensor,   # [B, N, 7, 2]
    peptide_features: torch.Tensor,   # [B, N, H]
    edge_pre_shard: torch.Tensor,     # [N, NPs, T] this rank's neighbour columns
    message_mask_shard: torch.Tensor, # [B, N, NPs] (self-exclusion included)
    neighbour_features: torch.Tensor, # [B, NPs, H]
    neighbour_frames: RigidArray,     # [B, NPs]
    group,
    tp_group=None,
) -> Tuple[RigidArray, torch.Tensor, torch.Tensor]:
    """One message-passing round with the neighbour axis split over
    ``group``; the dense layer's result on the unsplit inputs."""
    B, N = peptide_features.shape[:2]
    q_i, t_i = peptide_frames.quats, peptide_frames.trans
    mask = message_mask_shard.float()
    flat_torsions = peptide_torsions.reshape(B, N, N_TORSIONS * 2)

    logits, message, global_delta, m_delta_a, mr = _block_terms(
        layer, q_i, t_i, peptide_features, flat_torsions, neighbour_frames.quats,
        neighbour_frames.trans, neighbour_features, edge_pre_shard, mask, tp_group)

    g_max = all_reduce_max(torch.amax(logits, dim=-1), group)  # [B, N]
    expw = torch.exp(logits - g_max[..., None])                 # [B, N, NPs]
    w = expw[..., None]
    M = message.shape[-1]
    # one all-reduce: denominator, message sum (over ALL neighbours, masked
    # included: the reference's quirk), neighbour count, three numerators
    total = all_reduce_sum(torch.cat((
        torch.sum(expw, dim=-1, keepdim=True), torch.sum(message, dim=-2),
        torch.sum(mask, dim=-1, keepdim=True), torch.sum(w * global_delta, dim=-2),
        torch.sum(w * m_delta_a, dim=-2), torch.sum(w * mr, dim=-2)), dim=-1), group)
    denom = total[..., :1]
    msg_sum = total[..., 1:1 + M]
    has_nb = total[..., 1 + M] > 0.0
    gd, ta, tr = torch.split(total[..., 2 + M:] / denom, [4, N_TORSIONS, 3], dim=-1)
    return _finalize(layer, peptide_features, peptide_torsions, q_i, t_i, msg_sum, gd, ta, tr,
                     has_nb, tp_group)


def egnn_forward_ring(
    layer: EGNNLayer,
    peptide_frames_shard: RigidArray,       # [B, Ns] this rank's query slice
    peptide_torsions_shard: torch.Tensor,   # [B, Ns, 7, 2]
    peptide_features_shard: torch.Tensor,   # [B, Ns, H]
    edge_pre_shard: torch.Tensor,           # [N, NPs, T] (all N rows, resident columns)
    message_mask_shard: torch.Tensor,       # [B, N, NPs]
    neighbour_features: torch.Tensor,       # [B, NPs, H] resident
    neighbour_frames: RigidArray,           # [B, NPs] resident
    group,
    tp_group=None,
) -> Tuple[RigidArray, torch.Tensor, torch.Tensor]:
    """Ring context parallelism: at hop s rank d holds the query slice of
    rank (d - s) mod n, folds its own neighbour block into the slice's
    running softmax state, and sends slice and state to rank d + 1. After
    n hops every slice has seen every block and is home: outputs are
    split on the query axis."""
    B, Ns = peptide_features_shard.shape[:2]
    n, me = group_size(group), group_rank(group)
    M = layer.translation_mlp[0].in_features
    H = peptide_features_shard.shape[-1]
    mask_full = message_mask_shard.float()
    q_j, t_j = neighbour_frames.quats, neighbour_frames.trans
    f32 = dict(dtype=torch.float32, device=mask_full.device)

    # the travelling state, one flat buffer a hop: the query slice, then
    # the running max, denominator, rotation / torsion / translation
    # numerators, message sum and neighbour count
    widths = [4, 3, H, N_TORSIONS * 2, 1, 1, 4, N_TORSIONS, 3, M, 1]
    state = torch.cat((
        peptide_frames_shard.quats, peptide_frames_shard.trans, peptide_features_shard,
        peptide_torsions_shard.reshape(B, Ns, N_TORSIONS * 2),
        torch.full((B, Ns, 1), -INFINITY, **f32), torch.zeros((B, Ns, 1 + 4 + N_TORSIONS + 3 + M + 1),
                                                                **f32)), dim=-1)
    for s in range(n):
        q, t, h, tor, m, d, gd, ta, tr, msg, cnt = torch.split(state, widths, dim=-1)
        origin = (me - s) % n
        rows = slice(origin * Ns, (origin + 1) * Ns)
        mask = mask_full[:, rows]
        logits, message, global_delta, m_delta_a, mr = _block_terms(
            layer, q, t, h, tor, q_j, t_j, neighbour_features, edge_pre_shard[rows], mask,
            tp_group)
        # flash-style online rescale; the max carries no gradient
        new_m = torch.maximum(m[..., 0], torch.amax(logits, dim=-1)).detach()
        r = torch.exp(m[..., 0] - new_m)[..., None]  # [B, Ns, 1]
        lexp = torch.exp(logits - new_m[..., None])  # [B, Ns, NPs]
        w = lexp[..., None]
        state = torch.cat((
            q, t, h, tor, new_m[..., None], d * r + torch.sum(lexp, dim=-1, keepdim=True),
            gd * r + torch.sum(w * global_delta, dim=-2), ta * r + torch.sum(w * m_delta_a, dim=-2),
            tr * r + torch.sum(w * mr, dim=-2), msg + torch.sum(message, dim=-2),
            cnt + torch.sum(mask, dim=-1, keepdim=True)), dim=-1)
        state = ring_shift(state, group)

    q, t, h, tor, _, d, gd, ta, tr, msg, cnt = torch.split(state, widths, dim=-1)
    return _finalize(layer, h, tor.reshape(B, Ns, N_TORSIONS, 2), q, t, msg, gd / d, ta / d,
                     tr / d, cnt[..., 0] > 0.0, tp_group)
