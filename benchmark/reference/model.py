"""The plain reference of the published network, its diffusion and its training step.

Plain PyTorch, written after the published model code (cmbi/pmhc-diffusion-model:
two EGNN layers over the fully connected peptide-pocket graph, 22+1 -> 64 -> 1
node features, six 2-layer MLPs a layer of hidden width 64). It imports nothing
of the system under test and takes only the weights and inputs the benchmark
made. Every function takes the weights as a ``{state_dict key: tensor}`` dict
(the keys of the published ``model.pth``) and computes in the dtype of its
inputs, float32 unless a caller asks otherwise.

Quirks of the published model kept on purpose: the rotation MLP's sigmoid output
is used unnormalised as a quaternion delta; the attention mask is a -1e9
additive penalty; messages are summed over all neighbours (masked ones too) for
the feature update; the model is evaluated at t = T first.

The noise is drawn from a ``torch.Generator`` in the same calls and order as the
published sampler and trainer draw it, so the same generator seed gives the same
noise on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

T_STEPS = 1000
BETA_MIN, BETA_MAX = 0.0, 0.8
POSITION_NOISE_SCALE = 5.0
LOSS_WEIGHTS = (0.1, 1.0, 1.0)  # positions, rotations, torsions
N_TORSIONS = 7
INFINITY = 1e9
MAX_LEN = 16
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# ---------------------------------------------------------------- weights


def layer_shapes() -> Dict[str, Tuple[int, ...]]:
    """The 48 tensors of the published network (79,195 parameters)."""
    E, Tr, M = 2 * MAX_LEN - 1, 64, 64
    out = {}
    for name, H, O in (("gnn1", 23, 64), ("gnn2", 64, 1)):
        for mlp, n_in, n_out in (("feature_mlp", H + M, O), ("message_mlp", 2 * H + E, M),
                                 ("attention_mlp", M + 2, 1), ("translation_mlp", M, 1),
                                 ("rotation_mlp", M + 4, 4),
                                 ("torsion_mlp", M + N_TORSIONS * 2, N_TORSIONS)):
            p = f"{name}.{mlp}"
            out[f"{p}.0.weight"], out[f"{p}.0.bias"] = (Tr, n_in), (Tr,)
            out[f"{p}.2.weight"], out[f"{p}.2.bias"] = (n_out, Tr), (n_out,)
    return out


def make_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
    published layers' default init, drawn on ``device`` in one call from
    ``seed``."""
    shapes = layer_shapes()
    sizes = [math.prod(s) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out = {}
    for (key, shape), part in zip(shapes.items(), torch.split(u, sizes)):
        fan_in = shapes[key.replace(".bias", ".weight")][1]
        bound = 1.0 / math.sqrt(fan_in)
        out[key] = (part * (2.0 * bound) - bound).reshape(shape)
    return out


# ---------------------------------------------------------------- geometry


def normalize(x, eps=1e-12):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), min=eps)


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack((w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2), dim=-1)


def quat_inv(q):
    conj = torch.cat((q[..., :1], -q[..., 1:]), dim=-1)
    return conj / torch.sum(q * q, dim=-1, keepdim=True)


def quat_to_rot(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack((
        torch.stack((w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)), -1),
        torch.stack((2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)), -1),
        torch.stack((2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z), -1),
    ), dim=-2)


def partial_rot(q, amount):
    """The rotation angle of ``q`` scaled by ``amount``; not renormalised."""
    q = normalize(q)
    a2 = torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    return torch.cat((torch.cos(a2 * amount), torch.sin(a2 * amount) * normalize(q[..., 1:])), -1)


def sc_mul(a, b):
    s1, c1, s2, c2 = a[..., :1], a[..., 1:], b[..., :1], b[..., 1:]
    return torch.cat((s1 * c2 + c1 * s2, c1 * c2 - s1 * s2), dim=-1)


def sc_inv(sc):
    return torch.cat((-sc[..., :1], sc[..., 1:]), dim=-1) / torch.sum(sc * sc, -1, keepdim=True)


def sc_partial(sc, amount):
    sc = normalize(sc)
    a = torch.arccos(torch.clamp(sc[..., 1:], -1.0, 1.0))
    a = torch.where(sc[..., :1] < 0.0, -a, a)
    return torch.cat((torch.sin(a * amount), torch.cos(a * amount)), dim=-1)


# ---------------------------------------------------------------- network


def _mlp(w, prefix, x, sigmoid=False):
    h = torch.relu(x @ w[f"{prefix}.0.weight"].T + w[f"{prefix}.0.bias"])
    y = h @ w[f"{prefix}.2.weight"].T + w[f"{prefix}.2.bias"]
    return torch.sigmoid(y) if sigmoid else y


def egnn_layer(w, name, q, t, tors, h, mask, pocket_h, pocket_q, pocket_t, pocket_mask):
    """One message-passing round of the published layer, on the whole
    concatenated inputs: ``cat(h_i, h_j, relpos one-hot)`` into each MLP."""
    B, N = mask.shape
    P = pocket_mask.shape[-1]
    NP = N + P
    dt = h.dtype
    not_self = 1.0 - torch.eye(N, dtype=dt, device=h.device)
    msg_mask = torch.cat((mask[:, :, None] * mask[:, None, :] * not_self,
                          mask[:, :, None] * pocket_mask[:, None, :]), dim=-1)
    q_j, t_j = torch.cat((q, pocket_q), 1), torch.cat((t, pocket_t), 1)
    h_j = torch.cat((h, pocket_h), 1)
    r = torch.arange(N, device=h.device)
    relpos = (N - 1) + (r[:, None] - r[None, :])
    onehot = torch.nn.functional.one_hot(relpos, 2 * N - 1).to(dt)           # [N, N, E]
    edge = torch.nn.functional.pad(onehot, (0, 0, 0, P))                   # [N, NP, E]
    x = torch.cat((h[:, :, None, :].expand(B, N, NP, h.shape[-1]),
                   h_j[:, None, :, :].expand(B, N, NP, h.shape[-1]),
                   edge[None].expand(B, N, NP, edge.shape[-1])), dim=-1)
    message = _mlp(w, f"{name}.message_mlp", x)                              # [B, N, NP, M]
    d2 = torch.sum((t[:, :, None] - t_j[:, None]) ** 2, -1)
    qdot2 = torch.sum(q[:, :, None] * q_j[:, None], -1) ** 2
    att = _mlp(w, f"{name}.attention_mlp",
               torch.cat((message, -d2[..., None], qdot2[..., None]), -1))[..., 0]
    weights = torch.softmax(att - (1.0 - msg_mask) * INFINITY, dim=-1)
    node = _mlp(w, f"{name}.feature_mlp", torch.cat((h, message.sum(-2)), -1))
    inv_qj = quat_inv(q_j)[:, None]
    local = quat_mul(inv_qj, quat_mul(q[:, :, None], q_j[:, None]))
    delta = _mlp(w, f"{name}.rotation_mlp", torch.cat((message, local), -1), sigmoid=True)
    gd = torch.sum(quat_mul(q_j[:, None], quat_mul(delta, inv_qj)) * weights[..., None], -2)
    has = torch.sum(msg_mask, -1) > 0.0
    ident = torch.zeros_like(gd)
    ident[..., 0] = 1.0
    new_q = normalize(quat_mul(normalize(torch.where(has[..., None], gd, ident)), q))
    flat = tors.reshape(B, N, 1, N_TORSIONS * 2).expand(B, N, NP, N_TORSIONS * 2)
    da = torch.sum(_mlp(w, f"{name}.torsion_mlp", torch.cat((message, flat), -1))
                   * weights[..., None], -2)
    new_tors = sc_mul(torch.stack((torch.sin(da), torch.cos(da)), -1), tors)
    m = _mlp(w, f"{name}.translation_mlp", message)
    new_t = t + torch.sum(m * (t[:, :, None] - t_j[:, None]) * weights[..., None], -2)
    return new_q, new_t, new_tors, node


def score(w, batch, q, t, tors, t_model):
    """The noise the network predicts for the state (q, t, tors) at model
    time ``t_model`` (a [B] tensor of t / T)."""
    mask, pmask = batch["mask"], batch["pocket_mask"]
    B, N = mask.shape
    dt = q.dtype
    ft = t_model.to(dt).reshape(B, 1, 1).expand(B, N, 1)
    h = torch.cat((batch["features"], ft), -1)
    ph = torch.nn.functional.pad(batch["pocket_features"], (0, 1))
    pq, pt = batch["pocket_quats"], batch["pocket_trans"]
    q1, t1, tors1, inner = egnn_layer(w, "gnn1", q, t, tors, h, mask, ph, pq, pt, pmask)
    ph2 = torch.nn.functional.pad(ph, (0, inner.shape[-1] - ph.shape[-1]))
    q2, t2, tors2, _ = egnn_layer(w, "gnn2", q1, t1, tors1, torch.relu(inner), mask, ph2, pq, pt,
                                  pmask)
    return q2, t2, tors2


# ---------------------------------------------------------------- diffusion


class Schedule:
    """Linear beta with direct interpolation, in float64 on the host, kept as
    float32: index t in [0, T]."""

    def __init__(self, T: int = T_STEPS):
        beta = BETA_MIN + (BETA_MAX - BETA_MIN) * np.arange(T + 1, dtype=np.float64) / T
        alpha, sigma = np.sqrt(1.0 - beta), np.sqrt(beta)
        alpha_ts = np.ones_like(alpha)
        alpha_ts[1:] = alpha[1:] / alpha[:-1]
        sqr_sigma_ts = np.zeros_like(sigma)
        sqr_sigma_ts[1:] = sigma[1:] ** 2 - sigma[:-1] ** 2 * alpha_ts[1:]
        sigma_ts = np.sqrt(np.maximum(sqr_sigma_ts, 0.0))
        sigma_t2s = np.zeros_like(sigma)
        sigma_t2s[1:] = sigma_ts[1:] * sigma[:-1] / np.where(sigma[1:] > 0, sigma[1:], 1.0)
        self.T = T
        f32 = lambda x: x.astype(np.float32)  # noqa: E731
        self.beta, self.alpha, self.sigma = f32(beta), f32(alpha), f32(sigma)
        self.alpha_ts, self.sqr_sigma_ts, self.sigma_t2s = f32(alpha_ts), f32(sqr_sigma_ts), \
            f32(sigma_t2s)

    def step_scalars(self, t: int):
        return tuple(float(x) for x in (self.beta[t], self.sigma[t], self.beta[t - 1],
                                        self.alpha_ts[t], self.sqr_sigma_ts[t], self.sigma_t2s[t]))


def shoemake(x):
    x = torch.clamp(x, 0.0, 1.0)
    th1, th2 = 2.0 * math.pi * x[..., 1:2], 2.0 * math.pi * x[..., 2:3]
    r1, r2 = torch.sqrt(1.0 - x[..., 0:1]), torch.sqrt(x[..., 0:1])
    return torch.cat((r2 * torch.cos(th2), r1 * torch.sin(th1), r1 * torch.cos(th1),
                      r2 * torch.sin(th2)), -1)


def draw_noise(generator: torch.Generator, shape: Sequence[int]):
    """(quats, trans, torsions) of pure noise for batch shape ``shape``:
    translations N(0, 5^2), rotations uniform (Shoemake), torsions uniform
    angles, drawn in this order."""
    shape, dev = tuple(shape), generator.device
    trans = torch.randn(shape + (3,), generator=generator, device=dev,
                        dtype=torch.float32) * POSITION_NOISE_SCALE
    quats = shoemake(torch.rand(shape + (3,), generator=generator, device=dev,
                                dtype=torch.float32))
    a = torch.rand(shape + (N_TORSIONS,), generator=generator, device=dev, dtype=torch.float32)
    a = a * (2.0 * math.pi)
    return quats, trans, torch.stack((torch.sin(a), torch.cos(a)), -1)


def reverse_step(state, pred, rand, scalars):
    """z_t -> z_{t-1}: the posterior mean plus fresh noise, per component."""
    (q, t, tors), (pq, pt, ptors), (rq, rt, rtors) = state, pred, rand
    beta_t, sigma_t, beta_s, alpha_ts, sqr_sigma_ts, sigma_t2s = scalars
    pos = t / alpha_ts - (pt * sqr_sigma_ts) / (alpha_ts * sigma_t) + sigma_t2s * rt
    rot = quat_mul(partial_rot(rq, beta_s), quat_mul(quat_inv(partial_rot(pq, beta_t)), q))
    new_tors = sc_mul(sc_partial(rtors, beta_s),
                      sc_mul(sc_inv(sc_partial(ptors, beta_t)), tors))
    return rot, pos, new_tors


def sample_chain(w, batch, generator: torch.Generator, schedule: Schedule, dtype=torch.float32):
    """The full reverse chain from pure noise drawn from ``generator`` (the
    start state, then one draw a step); the network runs in ``dtype`` and the
    chain's state stays float32. Returns the final (quats, trans, torsions)."""
    B, N = batch["mask"].shape
    q, t, tors = draw_noise(generator, (B, N))
    wd = {k: v.to(dtype) for k, v in w.items()}
    bd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    with torch.no_grad():
        for step_t in range(schedule.T, 0, -1):
            tm = torch.full((B,), step_t / schedule.T, dtype=torch.float32, device=q.device)
            pred = score(wd, bd, q.to(dtype), t.to(dtype), tors.to(dtype), tm)
            pred = tuple(x.float() for x in pred)
            rand = draw_noise(generator, (B, N))
            q, t, tors = reverse_step((q, t, tors), pred, rand, schedule.step_scalars(step_t))
    return q, t, tors


def add_noise(batch, noise, t_idx, schedule: Schedule):
    """x0 -> z_t in one jump at per-example timesteps ``t_idx`` ([B] long)."""
    tab = torch.as_tensor(np.stack((schedule.beta, schedule.alpha, schedule.sigma)),
                          device=t_idx.device)[:, t_idx]
    beta, alpha, sigma = tab[0], tab[1], tab[2]
    nq, nt, ntors = noise
    tors = sc_mul(sc_partial(ntors, beta[:, None, None, None]), batch["torsions"])
    q = quat_mul(partial_rot(nq, beta[:, None, None]), batch["quats"])
    t = batch["trans"] * alpha[:, None, None] + nt * sigma[:, None, None]
    return q, t, tors


def loss_terms(noise, pred, mask, tmask):
    """Per-example (total, positions, rotations, torsions) of the published loss."""
    (nq, nt, ntors), (pq, pt, ptors) = noise, pred
    positions = torch.sum(torch.sum((nt - pt) ** 2, -1) * mask, -1) / torch.sum(mask, -1)
    rotations = torch.sum((1.0 - torch.sum(normalize(nq) * normalize(pq), -1)) * mask, -1) \
        / torch.sum(mask, -1)
    torsions = torch.sum((1.0 - torch.sum(normalize(ntors) * normalize(ptors), -1)) * tmask,
                         (-2, -1)) / torch.sum(tmask, (-2, -1))
    wp, wr, wt = LOSS_WEIGHTS
    return wp * positions + wr * rotations + wt * torsions, positions, rotations, torsions


def train_steps(w: Dict[str, torch.Tensor], batches: List[dict], t_draws: List[torch.Tensor],
                noise_generator: torch.Generator, lr: float = 1e-3, dtype=torch.float32,
                steps: int = T_STEPS):
    """Adam steps of the published loss, one per batch, with the timesteps
    ``t_draws`` and the noise drawn from ``noise_generator`` a step. Returns
    the mean total loss of each step, the first step's gradients and the
    parameters after the last step."""
    schedule = Schedule(steps)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, first_grads = [], None
    for step, (batch, t_idx) in enumerate(zip(batches, t_draws)):
        B, N = batch["mask"].shape
        noise = draw_noise(noise_generator, (B, N))
        q, t, tors = add_noise(batch, noise, t_idx, schedule)
        pd = {k: v.to(dtype) for k, v in params.items()}
        bd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        pred = score(pd, bd, q.to(dtype), t.to(dtype), tors.to(dtype),
                     t_idx.float() / schedule.T)
        pred = tuple(x.float() for x in pred)
        total = loss_terms(noise, pred, batch["mask"], batch["torsions_mask"])[0]
        mean = torch.sum(total) / B
        grads = torch.autograd.grad(mean, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(mean.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(params, grads)}
        bc1 = 1.0 - ADAM_B1 ** (step + 1)
        bc2 = 1.0 - ADAM_B2 ** (step + 1)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                mu[k].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu[k].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                p.add_(-lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))
    return losses, first_grads, {k: v.detach() for k, v in params.items()}
