"""The second score network: ESMFold's structure module (AlphaFold2's,
invariant point attention) over the peptide-pocket complex.

The module as ESMFold publishes it (``transformers``'
``EsmFoldStructureModule``; Jumper et al. 2021, Suppl. Information §1.8,
Algorithms 20-24) at its published widths (``StructureNetworkConfig``'s
defaults): ``layer_norm_s``, ``layer_norm_z``, ``linear_in``, then
``num_blocks`` weight-shared blocks of invariant point attention, a
LayerNorm, the transition and the backbone update, and the angle resnet on
the last block's ``s`` and ``s_initial``. Dropout is off (inference).

On ``score_network_forward``'s batch contract, in place of the EGNN. Its
inputs, which the published module takes from ESMFold's trunk and which
are assumed here:

- the single representation s0 = ``embed_s``(the 22-wide one-hot and the
  time feature t / T), 0 in the time slot on pocket rows, as for the EGNN;
- the pair representation z0 = ``embed_z`` of 74 features a pair: the
  peptide-peptide relative position one-hot (2 N - 1 = 31 wide, zero
  toward the pocket), a 4-way pair-kind one-hot (peptide or pocket x
  peptide or pocket), and a 39-bin distogram of pocket-pocket CA
  distances (AlphaFold2's template bins: lower edges linspace(3.25,
  50.75, 39) A, the last open), zero where either row is padding;
- the frames r = (q, t / ``trans_scale_factor``) of the peptide rows
  (the noised state, q normalised) and of the pocket rows. After each
  block the peptide rows compose the backbone update; the pocket rows'
  update is masked to the identity, so they stay where they are (a
  departure: ESMFold updates every row).

Outputs: the peptide rows' frames (q, t * ``trans_scale_factor``) and the
normalised angles [B, N, 7, 2] (sin, cos) of the last block; padded rows
and keys masked as in ESMFold (``inf``). The noised torsions enter no
input: the published module predicts its angles from s alone.

z is static over a chain and per complex: ``structure_context`` builds it
once a batch with the pocket rows' embeddings (the span
``structure.context``); ``structure_trunk`` runs the blocks from it. The
attention of each block is ``ops/ipa_attention.py`` (a hand-written CUDA
kernel on the card, its plain version on the CPU); the linears are fp32
``torch`` products (TF32 off, as ``SamplerService`` sets it). In ``bf16``
mode the linears' operands are rounded to bf16 with fp32 sums, the
attention unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from pmhc_tpu_torch.geometry import RigidArray, quat_multiply_by_vec, quat_to_rot
from pmhc_tpu_torch.utils.profiling import span

PAIR_KINDS = 4


@dataclass(frozen=True)
class StructureNetworkConfig:
    """ESMFold's ``StructureModuleConfig`` at its published values, and the
    inputs assumed here (``max_len``, ``node_input_size``, the distogram)."""

    max_len: int = 16  # peptide maxlen N
    node_input_size: int = 22  # sequence one-hot width
    noise_step_count: int = 1000  # T
    sequence_dim: int = 384
    pairwise_dim: int = 128
    ipa_dim: int = 16
    resnet_dim: int = 128
    num_heads_ipa: int = 12
    num_qk_points: int = 4
    num_v_points: int = 8
    num_blocks: int = 8
    num_transition_layers: int = 1
    num_resnet_blocks: int = 2
    num_angles: int = 7
    trans_scale_factor: float = 10.0
    epsilon: float = 1e-8
    inf: float = 1e5
    distogram_bins: int = 39
    distogram_min: float = 3.25
    distogram_max: float = 50.75

    @property
    def relposenc_depth(self) -> int:
        return self.max_len * 2 - 1

    @property
    def pair_input_size(self) -> int:
        return self.relposenc_depth + PAIR_KINDS + self.distogram_bins

    @property
    def node_feature_size(self) -> int:
        return self.node_input_size + 1  # + time feature


class InvariantPointAttention(nn.Module):
    """Algorithm 22's weights, named as ESMFold names them."""

    def __init__(self, c: StructureNetworkConfig):
        super().__init__()
        H, hc = c.num_heads_ipa, c.num_heads_ipa * c.ipa_dim
        self.linear_q = nn.Linear(c.sequence_dim, hc)
        self.linear_kv = nn.Linear(c.sequence_dim, 2 * hc)
        self.linear_q_points = nn.Linear(c.sequence_dim, H * c.num_qk_points * 3)
        self.linear_kv_points = nn.Linear(c.sequence_dim,
                                          H * (c.num_qk_points + c.num_v_points) * 3)
        self.linear_b = nn.Linear(c.pairwise_dim, H)
        self.head_weights = nn.Parameter(torch.zeros(H))
        self.linear_out = nn.Linear(H * (c.pairwise_dim + c.ipa_dim + c.num_v_points * 4),
                                    c.sequence_dim)


class TransitionLayer(nn.Module):
    def __init__(self, c: StructureNetworkConfig):
        super().__init__()
        d = c.sequence_dim
        self.linear_1, self.linear_2, self.linear_3 = (nn.Linear(d, d) for _ in range(3))


class Transition(nn.Module):
    def __init__(self, c: StructureNetworkConfig):
        super().__init__()
        self.layers = nn.ModuleList(TransitionLayer(c) for _ in range(c.num_transition_layers))
        self.layer_norm = nn.LayerNorm(c.sequence_dim)


class BackboneUpdate(nn.Module):
    def __init__(self, c: StructureNetworkConfig):
        super().__init__()
        self.linear = nn.Linear(c.sequence_dim, 6)


class AngleResnetBlock(nn.Module):
    def __init__(self, c: StructureNetworkConfig):
        super().__init__()
        self.linear_1 = nn.Linear(c.resnet_dim, c.resnet_dim)
        self.linear_2 = nn.Linear(c.resnet_dim, c.resnet_dim)


class AngleResnet(nn.Module):
    def __init__(self, c: StructureNetworkConfig):
        super().__init__()
        self.linear_in = nn.Linear(c.sequence_dim, c.resnet_dim)
        self.linear_initial = nn.Linear(c.sequence_dim, c.resnet_dim)
        self.layers = nn.ModuleList(AngleResnetBlock(c) for _ in range(c.num_resnet_blocks))
        self.linear_out = nn.Linear(c.resnet_dim, c.num_angles * 2)


class StructureNetwork(nn.Module):
    """The input embeddings (``embed_s``, ``embed_z``) and ESMFold's
    structure module under its own names (``ipa``, ``transition``,
    ``bb_update``, ``angle_resnet``, ...): 2,037,932 parameters at the
    default config, of which 2,019,116 the published module's.
    ``generator`` draws every Linear's weight and bias from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) and the head weights from U(-1, 1), reproducibly; the
    LayerNorms keep weight 1 and bias 0."""

    def __init__(self, config: StructureNetworkConfig = StructureNetworkConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = config
        self.embed_s = nn.Linear(c.node_feature_size, c.sequence_dim)
        self.embed_z = nn.Linear(c.pair_input_size, c.pairwise_dim)
        self.layer_norm_s = nn.LayerNorm(c.sequence_dim)
        self.layer_norm_z = nn.LayerNorm(c.pairwise_dim)
        self.linear_in = nn.Linear(c.sequence_dim, c.sequence_dim)
        self.ipa = InvariantPointAttention(c)
        self.layer_norm_ipa = nn.LayerNorm(c.sequence_dim)
        self.transition = Transition(c)
        self.bb_update = BackboneUpdate(c)
        self.angle_resnet = AngleResnet(c)
        if generator is not None:
            with torch.no_grad():
                for lin in self.modules():
                    if isinstance(lin, nn.Linear):
                        bound = 1.0 / math.sqrt(lin.in_features)
                        for p in (lin.weight, lin.bias):
                            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
                self.ipa.head_weights.copy_(torch.rand(c.num_heads_ipa, generator=generator) * 2 - 1)


def linear(lin: nn.Linear, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``lin(x)`` in fp32; with ``bf16`` the operands rounded to bf16 first
    (fp32 sums, the bias added in fp32)."""
    if not bf16:
        return F.linear(x, lin.weight, lin.bias)
    r = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    return F.linear(r(x), r(lin.weight), lin.bias)


def pair_features(mask: torch.Tensor, pocket_mask: torch.Tensor, pocket_trans: torch.Tensor,
                  config: StructureNetworkConfig) -> torch.Tensor:
    """The 74 pair features [B, L, L, 74] (see the module's docstring) of
    peptide rows 0..N-1 and pocket rows N..N+P-1."""
    B, N = mask.shape
    P = pocket_mask.shape[-1]
    L, dev = N + P, mask.device
    r = torch.arange(N, device=dev)
    relpos = F.one_hot((N - 1) + (r[:, None] - r[None, :]), 2 * N - 1).float()
    relpos = F.pad(relpos, (0, 0, 0, P, 0, P))                               # [L, L, 31]
    pocket = (torch.arange(L, device=dev) >= N).long()
    kind = F.one_hot(2 * pocket[:, None] + pocket[None, :], PAIR_KINDS).float()  # [L, L, 4]
    d2 = torch.sum((pocket_trans[:, :, None] - pocket_trans[:, None]) ** 2, -1)  # [B, P, P]
    lower = torch.linspace(config.distogram_min, config.distogram_max, config.distogram_bins,
                           device=dev) ** 2
    upper = torch.cat((lower[1:], lower.new_full((1,), 1e8)))
    dgram = ((d2[..., None] > lower) & (d2[..., None] < upper)).float()
    dgram = dgram * (pocket_mask[:, :, None] * pocket_mask[:, None, :])[..., None]
    dgram = F.pad(dgram, (0, 0, N, 0, N, 0))                                 # [B, L, L, 39]
    fixed = torch.cat((relpos, kind), -1).expand(B, L, L, -1)
    return torch.cat((fixed, dgram), -1)


class StructureContext(NamedTuple):
    """A batch's static inputs of the blocks: z [B, L, L, C_z] after
    ``layer_norm_z``, s0 without its time feature [B, L, C_s], the time
    feature's column of ``embed_s`` on peptide rows (0 on pocket rows)
    [L, C_s], the row mask [B, L], the pocket rows' quats [B, P, 4] and
    translations [B, P, 3] (already over ``trans_scale_factor``), and the
    rows whose frames move (1 on peptide rows) [L, 1]."""

    z: torch.Tensor
    s0_static: torch.Tensor
    s0_time: torch.Tensor
    mask: torch.Tensor
    pocket_quats: torch.Tensor
    pocket_trans: torch.Tensor
    moves: torch.Tensor


def structure_context(model: StructureNetwork, batch: Dict[str, Any], bf16: bool = False
                      ) -> StructureContext:
    """Build a batch's ``StructureContext`` (the span ``structure.context``)."""
    c = model.config
    with span("structure.context"):
        mask = batch["mask"].float()
        pocket_mask = batch["pocket_mask"].float()
        B, N = mask.shape
        P = pocket_mask.shape[-1]
        dev = mask.device
        pf: RigidArray = batch["pocket_frames"]
        feats = torch.cat((batch["features"].float(), batch["pocket_features"].float()), 1)
        s0_static = linear(model.embed_s, F.pad(feats, (0, 1)), bf16)
        moves = torch.zeros(N + P, 1, device=dev)
        moves[:N] = 1.0
        s0_time = moves * model.embed_s.weight[:, -1]
        z0 = linear(model.embed_z, pair_features(mask, pocket_mask, pf.trans.float(), c), bf16)
        z = model.layer_norm_z(z0).contiguous()
        return StructureContext(z, s0_static, s0_time, torch.cat((mask, pocket_mask), 1),
                                pf.quats.float(), pf.trans.float() / c.trans_scale_factor,
                                moves)


def to_global(pts: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """A points linear's output [B, L, 3 n] (x, y, z chunks of n points, as
    ESMFold splits it) in the rows' frames -> global points [B, L, n, 3]."""
    B, L, n3 = pts.shape
    local = pts.view(B, L, 3, n3 // 3).transpose(-1, -2)
    return torch.matmul(local, rot.transpose(-1, -2)) + trans[:, :, None, :]


def structure_trunk(model: StructureNetwork, ctx: StructureContext, q: torch.Tensor,
                    t: torch.Tensor, x: torch.Tensor, bf16: bool = False):
    """The blocks and the angle resnet from ``ctx`` at the peptide state
    (q [B, N, 4], t [B, N, 3]) and model time ``x`` (a [1] or [B] tensor of
    t / T). Returns the predicted (q [B, N, 4], t [B, N, 3], angles
    [B, N, 7, 2])."""
    from pmhc_tpu_torch.ops.ipa_attention import ipa_attention

    c = model.config
    N = q.shape[1]
    ipa = model.ipa
    s = ctx.s0_static + x.reshape(-1, 1, 1) * ctx.s0_time
    s = model.layer_norm_s(s)
    s_initial = s
    s = linear(model.linear_in, s, bf16)
    quats = torch.cat((F.normalize(q.float(), dim=-1), ctx.pocket_quats), 1)
    trans = torch.cat((t.float() / c.trans_scale_factor, ctx.pocket_trans), 1)
    rot = quat_to_rot(quats)
    for _ in range(c.num_blocks):
        o = ipa_attention(linear(ipa.linear_q, s, bf16), linear(ipa.linear_kv, s, bf16),
                          to_global(linear(ipa.linear_q_points, s, bf16), rot, trans),
                          to_global(linear(ipa.linear_kv_points, s, bf16), rot, trans),
                          rot, trans, ctx.mask, ctx.z, ipa.linear_b.weight, ipa.linear_b.bias,
                          ipa.head_weights, c.inf, c.epsilon)
        s = model.layer_norm_ipa(s + linear(ipa.linear_out, o, bf16))
        for layer in model.transition.layers:
            h = torch.relu(linear(layer.linear_1, s, bf16))
            h = torch.relu(linear(layer.linear_2, h, bf16))
            s = linear(layer.linear_3, h, bf16) + s
        s = model.transition.layer_norm(s)
        # the backbone update, the identity on the rows that stay
        update = linear(model.bb_update.linear, s, bf16) * ctx.moves
        trans = trans + torch.matmul(rot, update[..., 3:, None])[..., 0]
        quats = F.normalize(quats + quat_multiply_by_vec(quats, update[..., :3]), dim=-1)
        rot = quat_to_rot(quats)
    angles = angle_resnet(model, s, s_initial, bf16)
    return (quats[:, :N].contiguous(), (trans[:, :N] * c.trans_scale_factor).contiguous(),
            angles[:, :N].contiguous())


def angle_resnet(model: StructureNetwork, s, s_initial, bf16: bool = False) -> torch.Tensor:
    """Algorithm 20, lines 11-14, as ESMFold computes it: the normalised
    angles [B, L, 7, 2]."""
    m = model.angle_resnet
    a = linear(m.linear_in, torch.relu(s), bf16) + linear(m.linear_initial,
                                                          torch.relu(s_initial), bf16)
    for block in m.layers:
        h = linear(block.linear_1, torch.relu(a), bf16)
        a = linear(block.linear_2, torch.relu(h), bf16) + a
    a = linear(m.linear_out, torch.relu(a), bf16)
    a = a.view(a.shape[:-1] + (-1, 2))
    return a / torch.sqrt(torch.clamp(torch.sum(a * a, -1, keepdim=True),
                                      min=model.config.epsilon))


def structure_network_forward(model: StructureNetwork, batch: Dict[str, Any], t,
                              bf16: bool = False) -> Dict[str, Any]:
    """``score_network_forward``'s contract for the structure network: the
    predicted ``{"frames": RigidArray, "torsions": [B, N, 7, 2]}`` of
    ``batch``'s state at timestep ``t`` (an int or a [B] tensor)."""
    ctx = structure_context(model, batch, bf16)
    dev = ctx.mask.device
    x = torch.as_tensor(t, dtype=torch.float32, device=dev) / model.config.noise_step_count
    f: RigidArray = batch["frames"]
    q, tr, angles = structure_trunk(model, ctx, f.quats, f.trans, x.reshape(-1), bf16)
    return {"frames": RigidArray(q, tr), "torsions": angles}
