"""Reverse-diffusion sampler: T (or K strided) steps through the score network.

Counterpart of ``pmhc_tpu/diffusion/sampler_lane.py::sample_lane`` in the
``[B, N, C]`` layout (no lane packing, no batch grid). With the fused
backend the static context is built once before the chain:

- the packed (folded) weights of both layers;
- the edge terms, zero toward the pocket, and the message mask;
- the pocket-side neighbour projections a_j of both layers;
- the static 22-dim part of layer 1's peptide a_j plus its time row.

Each step then runs the layer-2 peptide projection relu(inner) @ W1[H:2H]
(a plain ``torch.matmul``), two fused-layer launches, and
``remove_noise``. In bf16 mode the neighbour projections take one bf16
pass (operands rounded, fp32 sums), as ``sample_lane``'s DEFAULT-precision
XLA matmuls do on the TPU. The dense backend evaluates ``score_network_forward``
per step instead (the oracle path). The ``pallas`` backend runs the JAX
package's generic sampler step, two ``ops/egnn_pallas.py`` launches per
step, with its static context (packed weights, message mask, edge terms,
the pocket halves of ``h_all``, ``q_j`` and ``t_j``) built once.

Semantics match ``sample_lane``: t runs T..1 with the model evaluated at
t = T first; ``injected_noise`` (a Noise dict with a leading [T] axis,
index 0 used at t = T, or [K] when strided) bypasses the generator for
exact trajectory parity in tests.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.nn import functional as F

from pmhc_tpu_torch.diffusion.noise import gen_noise, remove_noise_scalars
from pmhc_tpu_torch.diffusion.schedule import (
    DiffusionConfig,
    ScheduleTables,
    StridedTables,
    strided_timesteps,
)
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models.score import (
    ScoreNetwork,
    ScoreNetworkConfig,
    relpos_edge_pre,
    resolve_backend,
    score_network_forward,
)
from pmhc_tpu_torch.ops.egnn_fused import layer_context
from pmhc_tpu_torch.ops.egnn_pallas import pallas_context

Forward = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], tuple]


def fused_forward(model: ScoreNetwork, batch: Dict[str, Any],
                  model_config: ScoreNetworkConfig, bf16: bool) -> Forward:
    """Build both layers' static context once; return forward(q, t, tors, step)."""
    mask = batch["mask"].float()
    pocket_mask = batch["pocket_mask"].float()
    B, N = mask.shape
    P = pocket_mask.shape[-1]
    H1, H2 = model_config.node_feature_size, model_config.inner_size
    g1, g2 = model.gnn1, model.gnn2
    dev = mask.device

    feats22 = batch["features"].float()
    pocket_h = torch.cat(
        (batch["pocket_features"].float(), torch.zeros((B, P, 1), device=dev)), dim=-1)
    pocket_inner = F.pad(pocket_h, (0, H2 - H1))
    pf = batch["pocket_frames"]
    with torch.no_grad():
        ctx1 = layer_context(g1, relpos_edge_pre(g1, N), mask, pocket_h, pf, pocket_mask, bf16)
        ctx2 = layer_context(g2, relpos_edge_pre(g2, N), mask, pocket_inner, pf, pocket_mask, bf16)
        # layer 1's peptide a_j: the static 22-dim part (time slot 0) plus the
        # time row, added in fp32 each step
        aj1_static = ctx1.project(F.pad(feats22, (0, 1)))          # [B, N, T]
        wj1_time = ctx1.wj_t[-1].contiguous()                       # [T]
    inv_T = np.float32(1.0 / model_config.noise_step_count)

    def forward(q, t, tors, step: int):
        tf = float(np.float32(step) * inv_T)
        h1 = torch.cat((feats22, torch.full((B, N, 1), tf, device=dev)), dim=-1)
        q1, t1, tors1, inner = ctx1(h1, q, t, tors, aj1_static + tf * wj1_time)
        h2 = torch.relu(inner)
        q2, t2, tors2, _ = ctx2(h2, q1, t1, tors1, ctx2.project(h2))
        return q2, t2, tors2

    return forward


def pallas_forward(model: ScoreNetwork, batch: Dict[str, Any],
                   model_config: ScoreNetworkConfig) -> Forward:
    """``score_network_forward`` with the ``pallas`` backend, its static
    context built once; return forward(q, t, tors, step)."""
    mask = batch["mask"].float()
    pocket_mask = batch["pocket_mask"].float()
    B, N = mask.shape
    P = pocket_mask.shape[-1]
    H1, H2 = model_config.node_feature_size, model_config.inner_size
    g1, g2 = model.gnn1, model.gnn2
    dev = mask.device

    feats22 = batch["features"].float()
    pocket_h = torch.cat(
        (batch["pocket_features"].float(), torch.zeros((B, P, 1), device=dev)), dim=-1)
    pf = batch["pocket_frames"]
    with torch.no_grad():
        ctx1 = pallas_context(g1, relpos_edge_pre(g1, N), mask, pocket_h, pf, pocket_mask)
        ctx2 = pallas_context(g2, relpos_edge_pre(g2, N), mask, F.pad(pocket_h, (0, H2 - H1)), pf,
                              pocket_mask)
    T_f32 = np.float32(model_config.noise_step_count)

    def forward(q, t, tors, step: int):
        tf = float(np.float32(step) / T_f32)  # t / T in fp32, as score_network_forward
        h1 = torch.cat((feats22, torch.full((B, N, 1), tf, device=dev)), dim=-1)
        q1, t1, tors1, inner = ctx1(h1, q, t, tors)
        q2, t2, tors2, _ = ctx2(torch.relu(inner), q1, t1, tors1)
        return q2, t2, tors2

    return forward


def dense_forward(model: ScoreNetwork, batch: Dict[str, Any],
                  model_config: ScoreNetworkConfig) -> Forward:
    def forward(q, t, tors, step: int):
        state = dict(batch, frames=RigidArray(q, t), torsions=tors)
        pred = score_network_forward(model, state, step, model_config)
        return pred["frames"].quats, pred["frames"].trans, pred["torsions"]

    return forward


@torch.no_grad()
def sample(
    model: ScoreNetwork,
    batch: Dict[str, Any],
    config: DiffusionConfig,
    model_config: ScoreNetworkConfig,
    tables: ScheduleTables | None = None,
    generator: torch.Generator | None = None,
    bf16: bool = False,
    injected_noise: Dict[str, Any] | None = None,
    num_steps: int | None = None,
) -> Dict[str, Any]:
    """Full reverse diffusion from the noised state in ``batch``.

    ``batch``: the ``score_network_forward`` contract, all on one device.
    ``bf16`` selects the fused kernel's bf16 mode (the ``pallas`` and
    ``dense`` backends run fp32). ``num_steps`` (K) below
    T runs the strided few-step sampler. Fresh per-step noise comes from
    ``generator`` (on the batch's device) unless ``injected_noise`` is
    given. Returns ``batch`` with ``frames`` and ``torsions`` replaced.
    """
    if tables is None:
        tables = ScheduleTables(config)
    T_steps = config.noise_step_count
    if num_steps is not None and num_steps != T_steps:
        st = StridedTables(config, strided_timesteps(T_steps, num_steps))
        steps = [(int(st.ts[k]), st.scalars(k)) for k in range(st.num_jumps)]
    else:
        steps = [(t, tables.scalars(t)) for t in range(T_steps, 0, -1)]
    if injected_noise is None and generator is None:
        raise ValueError("sample needs a generator or injected_noise")

    backend = resolve_backend(model_config.backend)
    if backend == "fused":
        forward = fused_forward(model, batch, model_config, bf16)
    elif backend == "pallas":
        forward = pallas_forward(model, batch, model_config)
    else:
        forward = dense_forward(model, batch, model_config)

    shape = tuple(batch["mask"].shape)
    q = batch["frames"].quats.float().contiguous()
    t = batch["frames"].trans.float().contiguous()
    tors = batch["torsions"].float().contiguous()
    for k, (t_model, scalars) in enumerate(steps):
        q_p, t_p, tors_p = forward(q, t, tors, t_model)
        if injected_noise is None:
            rand = gen_noise(generator, shape, config)
        else:
            rf = injected_noise["frames"]
            rand = {"frames": RigidArray(rf.quats[k], rf.trans[k]),
                    "torsions": injected_noise["torsions"][k]}
        out = remove_noise_scalars(
            {"frames": RigidArray(q, t), "torsions": tors},
            {"frames": RigidArray(q_p, t_p), "torsions": tors_p},
            rand, *scalars)
        q = out["frames"].quats.contiguous()
        t = out["frames"].trans.contiguous()
        tors = out["torsions"].contiguous()

    result = dict(batch)
    result["frames"] = RigidArray(q, t)
    result["torsions"] = tors
    return result
