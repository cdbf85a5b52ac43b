"""The plain reference of the second score network: ESMFold's structure
module over the peptide-pocket complex.

Plain PyTorch, written from AlphaFold2's Supplementary Information §1.8
(Algorithms 20-24: the structure module, invariant point attention, the
backbone update, the transition, the angle resnet) and ESMFold's code
(``transformers``' ``modeling_esmfold.py``: ``EsmFoldStructureModule``,
``EsmFoldInvariantPointAttention``, ``EsmFoldBackboneUpdate``,
``EsmFoldStructureModuleTransition``, ``EsmFoldAngleResnet``, and the
``Rigid`` / ``Rotation`` arithmetic of ``openfold_utils/rigid_utils.py``).
It imports nothing of the system under test and takes only the weights and
inputs the benchmark made. Weights are a ``{state_dict key: tensor}``
dict; everything computes in float32.

ESMFold as published, with its quirks: biases on IPA's linears (the
supplement has none); ReLUs on the angle resnet's inputs; the attention
mask ``inf`` (m_i m_j - 1) with ``inf`` 1e5; quaternion updates (1, x, y,
z) composed as q + q (x) (0, v) and normalised; translations updated with
the old rotation; the angles of the last block. Departures (the inputs the
published module takes from ESMFold's trunk, assumed here, and the
diffusion's frames):

- s0 = ``embed_s``(22-wide one-hot, t / T), 0 in the time slot on pocket
  rows; z0 = ``embed_z``(peptide-peptide relative position one-hot 2N - 1
  wide, a 4-way pair-kind one-hot, a 39-bin pocket-pocket CA distogram
  with AlphaFold2's template bins, lower edges linspace(3.25, 50.75, 39)
  A and the last open, zero where either row is padding);
- the blocks start from the frames (q normalised, t / 10) of the noised
  peptide and of the pocket, not from the identity; the pocket rows'
  backbone update is masked to the identity;
- dropout off (inference); random weights from the seed;
- the output, the predicted noise of the diffusion: the peptide rows'
  frames (q, 10 t) and normalised angles; the noised torsions enter no
  input.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.nn import functional as F

CONFIG = {
    "max_len": 16, "node_input_size": 22, "sequence_dim": 384, "pairwise_dim": 128,
    "ipa_dim": 16, "resnet_dim": 128, "num_heads_ipa": 12, "num_qk_points": 4,
    "num_v_points": 8, "num_blocks": 8, "num_transition_layers": 1, "num_resnet_blocks": 2,
    "num_angles": 7, "trans_scale_factor": 10.0, "epsilon": 1e-8, "inf": 1e5,
    "distogram_bins": 39, "distogram_min": 3.25, "distogram_max": 50.75,
}
LN_EPS = 1e-5


def config(**widths) -> dict:
    return {**CONFIG, **widths}


def shapes(cfg: dict = CONFIG) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the network under its ``state_dict`` key."""
    cs, cz, H = cfg["sequence_dim"], cfg["pairwise_dim"], cfg["num_heads_ipa"]
    C, Pq, Pv, cr = cfg["ipa_dim"], cfg["num_qk_points"], cfg["num_v_points"], cfg["resnet_dim"]
    pair_in = 2 * cfg["max_len"] - 1 + 4 + cfg["distogram_bins"]
    out: Dict[str, Tuple[int, ...]] = {}

    def lin(name, i, o):
        out[f"{name}.weight"], out[f"{name}.bias"] = (o, i), (o,)

    def ln(name, d):
        out[f"{name}.weight"], out[f"{name}.bias"] = (d,), (d,)

    lin("embed_s", cfg["node_input_size"] + 1, cs)
    lin("embed_z", pair_in, cz)
    ln("layer_norm_s", cs)
    ln("layer_norm_z", cz)
    lin("linear_in", cs, cs)
    out["ipa.head_weights"] = (H,)
    lin("ipa.linear_q", cs, H * C)
    lin("ipa.linear_kv", cs, 2 * H * C)
    lin("ipa.linear_q_points", cs, H * Pq * 3)
    lin("ipa.linear_kv_points", cs, H * (Pq + Pv) * 3)
    lin("ipa.linear_b", cz, H)
    lin("ipa.linear_out", H * (cz + C + 4 * Pv), cs)
    ln("layer_norm_ipa", cs)
    for i in range(cfg["num_transition_layers"]):
        for k in (1, 2, 3):
            lin(f"transition.layers.{i}.linear_{k}", cs, cs)
    ln("transition.layer_norm", cs)
    lin("bb_update.linear", cs, 6)
    lin("angle_resnet.linear_in", cs, cr)
    lin("angle_resnet.linear_initial", cs, cr)
    for i in range(cfg["num_resnet_blocks"]):
        lin(f"angle_resnet.layers.{i}.linear_1", cr, cr)
        lin(f"angle_resnet.layers.{i}.linear_2", cr, cr)
    lin("angle_resnet.linear_out", cr, 2 * cfg["num_angles"])
    return out


def make_weights(seed: int, device, cfg: dict = CONFIG) -> Dict[str, torch.Tensor]:
    """Every Linear's weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    and the head weights from U(-1, 1), drawn on ``device`` in one call
    from ``seed``; the LayerNorms weight 1 and bias 0 (ESMFold's init)."""
    sh = shapes(cfg)
    drawn = [k for k in sh if "layer_norm" not in k]
    sizes = [math.prod(sh[k]) for k in drawn]
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out = {}
    for key, part in zip(drawn, torch.split(u, sizes)):
        if key == "ipa.head_weights":
            bound = 1.0
        else:
            bound = 1.0 / math.sqrt(sh[key.replace(".bias", ".weight")][1])
        out[key] = (part * (2.0 * bound) - bound).reshape(sh[key])
    for key in sh:
        if key not in out:
            fill = torch.ones if key.endswith(".weight") else torch.zeros
            out[key] = fill(sh[key], device=device, dtype=torch.float32)
    return {k: out[k] for k in sh}


# ---------------------------------------------------------------- rigid arithmetic


def quat_to_rot(q):
    """openfold's ``quat_to_rot`` (a unit quaternion, scalar first)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack((
        torch.stack((w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)), -1),
        torch.stack((2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)), -1),
        torch.stack((2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z), -1),
    ), dim=-2)


def quat_multiply_by_vec(q, v):
    """q (x) (0, v)."""
    w1, x1, y1, z1 = q.unbind(-1)
    x2, y2, z2 = v.unbind(-1)
    return torch.stack((-x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2), -1)


def normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def apply(rot, trans, pts):
    """``Rigid.apply``: R p + t, the frame broadcast over ``pts``' extra axes."""
    return torch.einsum("...xy,...y->...x", rot, pts) + trans


def invert_apply(rot, trans, pts):
    """``Rigid.invert_apply``: R^T (p - t)."""
    return torch.einsum("...yx,...y->...x", rot, pts - trans)


# ---------------------------------------------------------------- the blocks


def _lin(w, name, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def ipa(w, s, z, rot, trans, mask, cfg: dict = CONFIG):
    """``EsmFoldInvariantPointAttention.forward``: s [*, L, C_s], z [*, L,
    L, C_z], the frames (rot [*, L, 3, 3], trans [*, L, 3]), mask [*, L]
    -> the update of s [*, L, C_s]."""
    H, C, Pq, Pv = cfg["num_heads_ipa"], cfg["ipa_dim"], cfg["num_qk_points"], cfg["num_v_points"]
    q = _lin(w, "ipa.linear_q", s)
    q = q.view(q.shape[:-1] + (H, -1))
    kv = _lin(w, "ipa.linear_kv", s)
    kv = kv.view(kv.shape[:-1] + (H, -1))
    k, v = torch.split(kv, C, dim=-1)
    q_pts = _lin(w, "ipa.linear_q_points", s)
    q_pts = torch.stack(torch.split(q_pts, q_pts.shape[-1] // 3, dim=-1), dim=-1)
    q_pts = apply(rot[..., None, :, :], trans[..., None, :], q_pts)
    q_pts = q_pts.view(q_pts.shape[:-2] + (H, Pq, 3))
    kv_pts = _lin(w, "ipa.linear_kv_points", s)
    kv_pts = torch.stack(torch.split(kv_pts, kv_pts.shape[-1] // 3, dim=-1), dim=-1)
    kv_pts = apply(rot[..., None, :, :], trans[..., None, :], kv_pts)
    kv_pts = kv_pts.view(kv_pts.shape[:-2] + (H, -1, 3))
    k_pts, v_pts = torch.split(kv_pts, [Pq, Pv], dim=-2)

    b = _lin(w, "ipa.linear_b", z)                                           # [*, L, L, H]
    a = torch.matmul(q.transpose(-2, -3), k.permute(*range(k.dim() - 3), -2, -1, -3))
    a = a * math.sqrt(1.0 / (3 * C))
    a = a + math.sqrt(1.0 / 3) * b.movedim(-1, -3)
    pt_att = (q_pts.unsqueeze(-4) - k_pts.unsqueeze(-5)) ** 2
    pt_att = sum(torch.unbind(pt_att, dim=-1))
    head_weights = F.softplus(w["ipa.head_weights"]).view((1,) * (pt_att.dim() - 2) + (-1, 1))
    pt_att = pt_att * (head_weights * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2))))
    pt_att = torch.sum(pt_att, dim=-1) * (-0.5)
    square_mask = cfg["inf"] * (mask.unsqueeze(-1) * mask.unsqueeze(-2) - 1)
    a = a + pt_att.movedim(-1, -3) + square_mask.unsqueeze(-3)
    a = torch.softmax(a, dim=-1)                                             # [*, H, L, L]

    o = torch.matmul(a, v.transpose(-2, -3)).transpose(-2, -3).flatten(-2)
    o_pt = torch.sum(a[..., None, :, :, None] * v_pts.permute(*range(v_pts.dim() - 4), -3, -1,
                                                               -4, -2)[..., None, :, :], dim=-2)
    o_pt = o_pt.permute(*range(o_pt.dim() - 4), -2, -4, -1, -3)               # [*, L, H, Pv, 3]
    o_pt = invert_apply(rot[..., None, None, :, :], trans[..., None, None, :], o_pt)
    o_pt_norm = torch.sqrt(torch.sum(o_pt ** 2, dim=-1) + cfg["epsilon"]).flatten(-2)
    o_pt = o_pt.reshape(o_pt.shape[:-3] + (-1, 3))
    o_pair = torch.matmul(a.transpose(-2, -3), z).flatten(-2)
    return _lin(w, "ipa.linear_out",
                torch.cat((o, *torch.unbind(o_pt, dim=-1), o_pt_norm, o_pair), dim=-1))


def transition(w, s, cfg: dict = CONFIG):
    """``EsmFoldStructureModuleTransition`` (dropout off)."""
    for i in range(cfg["num_transition_layers"]):
        p = f"transition.layers.{i}"
        s0 = s
        s = torch.relu(_lin(w, f"{p}.linear_1", s))
        s = torch.relu(_lin(w, f"{p}.linear_2", s))
        s = _lin(w, f"{p}.linear_3", s) + s0
    return _ln(w, "transition.layer_norm", s)


def backbone_update(w, s, quats, trans, moves=None):
    """``EsmFoldBackboneUpdate`` and ``Rigid.compose_q_update_vec``: the
    new (quats, trans); ``moves`` [L] (1 or 0) masks a row's update."""
    update = _lin(w, "bb_update.linear", s)
    if moves is not None:
        update = update * moves[:, None]
    q_vec, t_vec = update[..., :3], update[..., 3:]
    new_trans = trans + apply(quat_to_rot(quats), torch.zeros_like(trans), t_vec)
    return normalize(quats + quat_multiply_by_vec(quats, q_vec)), new_trans


def angle_resnet(w, s, s_initial, cfg: dict = CONFIG):
    """``EsmFoldAngleResnet``: the normalised angles [*, 7, 2]."""
    s_initial = _lin(w, "angle_resnet.linear_initial", torch.relu(s_initial))
    a = _lin(w, "angle_resnet.linear_in", torch.relu(s)) + s_initial
    for i in range(cfg["num_resnet_blocks"]):
        p = f"angle_resnet.layers.{i}"
        a = _lin(w, f"{p}.linear_2", torch.relu(_lin(w, f"{p}.linear_1", torch.relu(a)))) + a
    a = _lin(w, "angle_resnet.linear_out", torch.relu(a))
    a = a.view(a.shape[:-1] + (-1, 2))
    return a / torch.sqrt(torch.clamp(torch.sum(a ** 2, dim=-1, keepdim=True),
                                      min=cfg["epsilon"]))


# ---------------------------------------------------------------- the network


def pair_features(batch, cfg: dict = CONFIG):
    """[B, L, L, 74]: relative position (peptide pairs), pair kind, the
    pocket-pocket distogram."""
    mask, pmask = batch["mask"], batch["pocket_mask"]
    B, N = mask.shape
    P = pmask.shape[-1]
    L, dev = N + P, mask.device
    feats = torch.zeros(B, L, L, 2 * N - 1 + 4 + cfg["distogram_bins"], device=dev)
    i = torch.arange(N, device=dev)
    feats[:, i[:, None], i[None, :], (N - 1) + i[:, None] - i[None, :]] = 1.0
    pocket = torch.arange(L, device=dev) >= N
    kind = 2 * pocket[:, None].long() + pocket[None, :].long()
    feats[..., 2 * N - 1:2 * N + 3] = F.one_hot(kind, 4).float()
    # AlphaFold2's dgram_from_positions: squared distances against squared breaks
    ca = batch["pocket_trans"]
    dist2 = torch.sum((ca[:, :, None] - ca[:, None]) ** 2, -1, keepdim=True)
    lower = torch.linspace(cfg["distogram_min"], cfg["distogram_max"], cfg["distogram_bins"],
                           device=dev) ** 2
    upper = torch.cat((lower[1:], torch.full((1,), 1e8, device=dev)))
    dgram = ((dist2 > lower) & (dist2 < upper)).float()
    feats[:, N:, N:, 2 * N + 3:] = dgram * (pmask[:, :, None] * pmask[:, None, :])[..., None]
    return feats


def context(w, batch, cfg: dict = CONFIG):
    """What the blocks read of a batch besides the peptide state: z after
    ``layer_norm_z``, the node features, the mask and the pocket frames."""
    z = _ln(w, "layer_norm_z", _lin(w, "embed_z", pair_features(batch, cfg)))
    return {"z": z, "features": torch.cat((batch["features"], batch["pocket_features"]), 1),
            "mask": torch.cat((batch["mask"], batch["pocket_mask"]), 1),
            "pocket_quats": batch["pocket_quats"],
            "pocket_trans": batch["pocket_trans"] / cfg["trans_scale_factor"],
            "N": batch["mask"].shape[1]}


def score(w, ctx, q, t, tors, t_model, cfg: dict = CONFIG):
    """The noise the network predicts for the peptide state (q, t; ``tors``
    unused) at model time ``t_model`` (a [B] tensor of t / T)."""
    N = ctx["N"]
    B, L = ctx["mask"].shape
    time = torch.zeros(B, L, 1, device=q.device)
    time[:, :N, 0] = t_model.float()[:, None]
    s = _ln(w, "layer_norm_s", _lin(w, "embed_s", torch.cat((ctx["features"], time), -1)))
    s_initial = s
    s = _lin(w, "linear_in", s)
    quats = torch.cat((normalize(q), ctx["pocket_quats"]), 1)
    trans = torch.cat((t / cfg["trans_scale_factor"], ctx["pocket_trans"]), 1)
    moves = (torch.arange(L, device=q.device) < N).float()
    for _ in range(cfg["num_blocks"]):
        s = s + ipa(w, s, ctx["z"], quat_to_rot(quats), trans, ctx["mask"], cfg)
        s = _ln(w, "layer_norm_ipa", s)
        s = transition(w, s, cfg)
        quats, trans = backbone_update(w, s, quats, trans, moves)
    angles = angle_resnet(w, s, s_initial, cfg)
    return quats[:, :N], trans[:, :N] * cfg["trans_scale_factor"], angles[:, :N]
