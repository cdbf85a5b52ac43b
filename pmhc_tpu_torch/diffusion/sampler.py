"""Reverse-diffusion sampler: T (or K strided) steps through the score network.

Counterpart of ``pmhc_tpu/diffusion/sampler_lane.py::sample_lane`` in the
``[B, N, C]`` layout (no lane packing, no batch grid). With the fused
backend the static context is built once before the chain:

- the packed (folded) weights of both layers;
- the edge terms, zero toward the pocket, and the message mask;
- the pocket-side neighbour projections a_j of both layers;
- the static 22-dim part of layer 1's peptide a_j plus its time row;
- the kernel's neighbour inputs of both layers, which persist over the
  chain: their pocket rows are written once, their peptide rows each step.

On the card a chain with a generator (``FusedForward.kernel_step``) then
takes a step in the three generator calls of its raw draws and four
launches: layer 1, the inter-layer kernel (h2 = relu(inner), layer 2's
peptide neighbour inputs with the projection relu(inner) @ W1[H:2H]),
layer 2, and the step kernel (``remove_noise`` into the state and layer
1's peptide neighbour inputs, the next step's time inputs, the counter;
``ops/sampler_step.py``). Elsewhere (the CPU, ``injected_noise``) a step
runs the plain composition of the same inputs and ``remove_noise``. In
bf16 mode the neighbour projections take one bf16 pass (operands rounded,
fp32 sums), as ``sample_lane``'s DEFAULT-precision XLA matmuls do on the
TPU; in high mode (``--fast-f32``) the kernel splits its products into
bf16 halves and the projections stay IEEE fp32, what ``sample_lane``'s
``Precision.HIGH`` matmuls give on the CPU. The dense backend evaluates
``score_network_forward`` per step instead (the oracle path). The
``pallas`` backend runs the JAX package's generic sampler step, two
``ops/egnn_pallas.py`` launches per step, with its static context (packed
weights, message mask, edge terms, the pocket halves of ``h_all``, ``q_j``
and ``t_j``) built once.

A step reads its model time and its six schedule scalars from tables on
the device (``schedule.step_tables``) at a step counter kept there and
advanced by the step itself, and writes the new state in place. So the
step is one body, run eagerly (on the CPU, with ``graphs=False``, or with
``injected_noise``) or from a CUDA graph (``utils/graphs.py``; the default
on the card), the counterpart of the JAX package's ``lax.scan`` over the
chain. A graph holds ``STEPS_PER_GRAPH`` steps (a last graph the
remainder), is captured once per backend, mode, batch shape and schedule
(``graph_cache`` keeps it) and is replayed K / ``STEPS_PER_GRAPH``
times; another batch of the same shape
copies its static context and start state into the graph's. The per-step
noise comes from a device generator registered with the graph: the
caller's generator state goes into it before the chain and comes back
after it, so the draws are those of the eager chain.

Semantics match ``sample_lane``: t runs T..1 with the model evaluated at
t = T first; ``injected_noise`` (a Noise dict with a leading [T] axis,
index 0 used at t = T, or [K] when strided) bypasses the generator for
exact trajectory parity in tests.

``make_sample_sharded`` / ``sample_sharded`` (the JAX package's names) run
the chain on a mesh, one process per GPU: each rank samples its ``data``
rows of the global batch with the ``cp`` or ``ring`` layer split over
``context``, draws every step's noise for the global batch from the same
generator and keeps its rows, so the trajectory is the dense sampler's on
the global batch; the rows are gathered back onto every rank at the end.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from pmhc_tpu_torch.diffusion.noise import Draws, draw_noise, gen_noise, remove_noise_scalars
from pmhc_tpu_torch.diffusion.schedule import DiffusionConfig, ScheduleTables, step_tables
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models.score import (
    ScoreNetwork,
    ScoreNetworkConfig,
    relpos_edge_pre,
    resolve_backend,
    score_network_forward,
)
from pmhc_tpu_torch.ops import sampler_step
from pmhc_tpu_torch.ops.egnn_fused import LayerContext, layer_context, mode_of
from pmhc_tpu_torch.ops.egnn_pallas import pallas_context
from pmhc_tpu_torch.parallel.comm import all_gather_flat
from pmhc_tpu_torch.parallel.mesh import data_rows, take_rows
from pmhc_tpu_torch.utils.graphs import GraphCache, Step, own_batch, use_graphs
from pmhc_tpu_torch.utils.profiling import span


# Steps a graph holds. With one step a graph, a T=1000 chain's replays (and
# the generator's two small copies before each) fill the card's launch
# queue, and the host waits in ``dispatch`` for most of the chain; with 10,
# ``dispatch`` returns at once and a caller's PDB text overlaps the next
# batch's sampling, for 1-2 % more device time a step (PERF.md §5).
STEPS_PER_GRAPH = 10


def model_time(backend: str, ts: np.ndarray, T: int) -> np.ndarray:
    """The model input of each step's timestep, as the backend's forward
    computes it in fp32: t * (1/T) (fused, ``sample_lane``), t / T
    (pallas, ``score_network_forward``), or t itself (dense)."""
    if backend == "fused":
        return ts.astype(np.float32) * np.float32(1.0 / T)
    if backend == "pallas":
        return ts.astype(np.float32) / np.float32(T)
    return ts


class Forward:
    """One backend's score network with its static context built:
    ``forward(q, t, tors, x)`` -> the predicted (q, t, tors). ``x`` is the
    step's timestep, an int or, on the chain's path, the ``[1]`` device
    tensor of its ``model_time``. ``static`` lists the device tensors the
    call reads besides its arguments (a captured step's static inputs)."""

    def __init__(self, fn: Callable, static: Sequence[torch.Tensor], backend: str, T: int):
        self.fn, self.static, self.backend, self.T = fn, list(static), backend, T

    def __call__(self, q, t, tors, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(model_time(self.backend, np.array([x], np.int64), self.T))
            x = x.to(q.device)
        return self.fn(q, t, tors, x)


class FusedForward(Forward):
    """The fused backend's score network over inputs that persist over the
    chain: layer 1's node input ``h1`` [B, N, 23] (the 22 static features
    and the time column), layer 2's ``h2`` [B, N, H2], and each layer's
    neighbour inputs (``LayerContext``: pocket rows written once, peptide
    rows each step). Calling it runs the plain composition, which writes
    those rows itself. On the card a chain with a generator steps by
    ``kernel_step`` instead (``Chain.step`` given ``Draws``), from the
    step's draws generated into buffers of its own (``draw``), after
    ``start`` has written the first step's inputs."""

    def __init__(self, ctx1: LayerContext, ctx2: LayerContext, h1: torch.Tensor,
                 aj1_static: torch.Tensor, wj1_time: torch.Tensor, T: int):
        super().__init__(self._plain, [h1, aj1_static, wj1_time, *ctx1.tensors(),
                                       *ctx2.tensors()], "fused", T)
        self.ctx1, self.ctx2, self.h1 = ctx1, ctx2, h1
        self.aj1_static, self.wj1_time = aj1_static, wj1_time
        B, N, _ = h1.shape
        dev = h1.device
        self.h2 = torch.empty((B, N, ctx2.w.H), device=dev)
        self.draws = tuple(torch.empty((B, N, n), device=dev) for n in (3, 3, 7))
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)  # the step kernel's

    def _plain(self, q, t, tors, tf):
        self.h1[..., -1:] = tf
        q1, t1, tors1, inner = self.ctx1(self.h1, q, t, tors,
                                         self.aj1_static + tf * self.wj1_time)
        h2 = torch.relu(inner)
        q2, t2, tors2, _ = self.ctx2(h2, q1, t1, tors1, self.ctx2.project(h2))
        return q2, t2, tors2

    def draw(self, generator: torch.Generator, config: DiffusionConfig) -> Draws:
        """The step's raw draws (``draw_noise``) into this forward's buffers."""
        return draw_noise(generator, self.h1.shape[:2], config, out=self.draws)

    def start(self, chain: "Chain") -> None:
        """The inputs of the chain's next step that ``kernel_step`` writes
        for the step after it: the time column of h1 and layer 1's peptide
        a_j at the chain's counter, its peptide q_j and t_j."""
        N = chain.q.shape[1]
        x = chain.xs.index_select(0, chain.k)
        self.h1[..., -1:] = x
        self.ctx1.aj[:, :N] = self.aj1_static + x * self.wj1_time
        self.ctx1.qj[:, :N] = chain.q
        self.ctx1.tj[:, :N] = chain.t

    def kernel_step(self, chain: "Chain", draws: Draws) -> None:
        """Step k -> k + 1 in four launches (``ops/sampler_step.py``)."""
        c1, c2 = self.ctx1, self.ctx2
        q1, t1, tors1, inner = c1.run(self.h1, chain.q, chain.t, chain.tors)
        sampler_step.inter_layer(inner, q1, t1, c2.wj_t, self.h2, c2.aj, c2.qj, c2.tj, c2.bf16)
        q2, t2, tors2, _ = c2.run(self.h2, q1, t1, tors1)
        sampler_step.step(chain.k, chain.xs, chain.sched, chain.q, chain.t, chain.tors,
                          q2, t2, tors2, draws, self.h1, self.aj1_static, self.wj1_time,
                          c1.aj, c1.qj, c1.tj, self.ticket, c1.bf16)


def fused_forward(model: ScoreNetwork, batch: Dict[str, Any], model_config: ScoreNetworkConfig,
                  bf16) -> FusedForward:
    """Build both layers' static context once; return its ``FusedForward``."""
    mask = batch["mask"].float()
    pocket_mask = batch["pocket_mask"].float()
    B, N = mask.shape
    P = pocket_mask.shape[-1]
    H1, H2 = model_config.node_feature_size, model_config.inner_size
    g1, g2 = model.gnn1, model.gnn2
    dev = mask.device

    h1 = F.pad(batch["features"].float(), (0, 1)).contiguous()  # the time column last
    pocket_h = torch.cat(
        (batch["pocket_features"].float(), torch.zeros((B, P, 1), device=dev)), dim=-1)
    pocket_inner = F.pad(pocket_h, (0, H2 - H1))
    pf = batch["pocket_frames"]
    with torch.no_grad():
        ctx1 = layer_context(g1, relpos_edge_pre(g1, N), mask, pocket_h, pf, pocket_mask, bf16)
        ctx2 = layer_context(g2, relpos_edge_pre(g2, N), mask, pocket_inner, pf, pocket_mask, bf16)
        # layer 1's peptide a_j: the static 22-dim part (time slot 0) plus the
        # time row, added in fp32 each step
        aj1_static = ctx1.project(h1)                               # [B, N, T]
        wj1_time = ctx1.wj_t[-1].contiguous()                       # [T]
    return FusedForward(ctx1, ctx2, h1, aj1_static, wj1_time, model_config.noise_step_count)


def pallas_forward(model: ScoreNetwork, batch: Dict[str, Any],
                   model_config: ScoreNetworkConfig) -> Forward:
    """``score_network_forward`` with the ``pallas`` backend, its static
    context built once."""
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

    def forward(q, t, tors, tf):
        h1 = torch.cat((feats22, tf.expand(B, N, 1)), dim=-1)
        q1, t1, tors1, inner = ctx1(h1, q, t, tors)
        q2, t2, tors2, _ = ctx2(torch.relu(inner), q1, t1, tors1)
        return q2, t2, tors2

    return Forward(forward, [feats22, *ctx1.tensors(), *ctx2.tensors()], "pallas",
                   model_config.noise_step_count)


def dense_forward(model: ScoreNetwork, batch: Dict[str, Any],
                  model_config: ScoreNetworkConfig, context_group=None) -> Forward:
    """``score_network_forward`` per step, reading ``batch`` (the ``cp`` and
    ``ring`` layers split over ``context_group``)."""
    def forward(q, t, tors, step):
        state = dict(batch, frames=RigidArray(q, t), torsions=tors)
        pred = score_network_forward(model, state, step, model_config,
                                     context_group=context_group)
        return pred["frames"].quats, pred["frames"].trans, pred["torsions"]

    pf = batch["pocket_frames"]
    return Forward(forward, [batch["features"], batch["mask"], batch["pocket_features"],
                             batch["pocket_mask"], pf.quats, pf.trans], "dense",
                   model_config.noise_step_count)


class Chain:
    """A reverse chain on the device: the state (q, t, tors) the steps
    update in place, the step counter ``k`` and the step tables (the model
    input ``xs`` [K] and the scalars ``sched`` [K, 6])."""

    def __init__(self, batch: Dict[str, Any], xs: np.ndarray, sched: np.ndarray):
        f = batch["frames"]
        dev = f.quats.device
        self.q = f.quats.float().clone(memory_format=torch.contiguous_format)
        self.t = f.trans.float().clone(memory_format=torch.contiguous_format)
        self.tors = batch["torsions"].float().clone(memory_format=torch.contiguous_format)
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)
        self.xs = torch.from_numpy(xs).to(dev)
        self.sched = torch.from_numpy(sched).to(dev)

    def restart(self, batch: Dict[str, Any]) -> None:
        """Start again from ``batch``'s state, in place."""
        self.q.copy_(batch["frames"].quats)
        self.t.copy_(batch["frames"].trans)
        self.tors.copy_(batch["torsions"])
        self.k.zero_()

    def step(self, forward: Forward, rand: Dict[str, Any] | Draws) -> None:
        """Step k -> k + 1 with the noise ``rand``; from ``Draws``, the
        step's raw draws, by the fused backend's kernels
        (``FusedForward.kernel_step``)."""
        if isinstance(rand, Draws):
            forward.kernel_step(self, rand)
            return
        x = self.xs.index_select(0, self.k)
        scalars = self.sched.index_select(0, self.k)[0].unbind()
        q_p, t_p, tors_p = forward(self.q, self.t, self.tors, x)
        out = remove_noise_scalars(
            {"frames": RigidArray(self.q, self.t), "torsions": self.tors},
            {"frames": RigidArray(q_p, t_p), "torsions": tors_p}, rand, *scalars)
        self.q.copy_(out["frames"].quats)
        self.t.copy_(out["frames"].trans)
        self.tors.copy_(out["torsions"])
        self.k += 1


def _noise(generator: torch.Generator, shape: Tuple[int, ...], config: DiffusionConfig,
           rows: Tuple[int, slice] | None) -> Dict[str, Any]:
    """One step's noise for a batch of ``shape``; with ``rows`` (the global
    batch size, this rank's slice) the global batch's, cut to the slice."""
    if rows is None:
        return gen_noise(generator, shape, config)
    return take_rows(gen_noise(generator, (rows[0],) + shape[1:], config), rows[1])


class _Graphed:
    """A chain with its own static context (``forward.static``) and noise
    generator, its step's noise drawn from that by ``draw``, and its
    captured steps by steps per graph."""

    def __init__(self, forward: Forward, chain: Chain, draw: Callable[[torch.Generator], Any]):
        self.forward, self.chain, self.draw = forward, chain, draw
        self.generator = torch.Generator(device=chain.q.device)
        self.steps: Dict[int, Step] = {}

    def run(self, n: int) -> None:
        """``n`` steps: one replay of the n-step graph (captured at its first
        use), the span ``sampler.replay``."""
        with span("sampler.replay"):
            step = self.steps.get(n)
            if step is None:
                def body():
                    for _ in range(n):
                        self.chain.step(self.forward, self.draw(self.generator))

                step = self.steps[n] = Step(body, [self.generator])
            step()


@torch.no_grad()
def sample(
    model: ScoreNetwork,
    batch: Dict[str, Any],
    config: DiffusionConfig,
    model_config: ScoreNetworkConfig,
    tables: ScheduleTables | None = None,
    generator: torch.Generator | None = None,
    bf16=False,
    injected_noise: Dict[str, Any] | None = None,
    num_steps: int | None = None,
    graphs: bool | None = None,
    graph_cache: GraphCache | None = None,
    mesh=None,
) -> Dict[str, Any]:
    """Full reverse diffusion from the noised state in ``batch``.

    ``batch``: the ``score_network_forward`` contract, all on one device.
    ``bf16`` selects the fused kernel's mode (``ops/egnn_fused.py::mode_of``:
    False fp32, True bf16, ``"high"`` the ``--fast-f32`` split products;
    the ``pallas`` and ``dense`` backends run fp32). ``num_steps`` (K) below
    T runs the strided few-step sampler. Fresh per-step noise comes from
    ``generator`` (on the batch's device) unless ``injected_noise`` is
    given. ``graphs`` (default: on a CUDA device, without
    ``injected_noise``) runs the chain from CUDA graphs of
    ``STEPS_PER_GRAPH`` steps kept in ``graph_cache`` (a new cache per call
    when None); a failed capture raises. Returns ``batch`` with ``frames``
    and ``torsions`` replaced. The chain, from its start state to its end
    state, is the span ``sampler.chain``; from graphs, its children are
    ``sampler.context`` (the batch's static context, start state and
    generator state into the graph's) and a ``sampler.replay`` per replay.

    ``mesh``: ``batch`` (and ``injected_noise``) are this rank's ``data``
    rows of a global batch split evenly over the mesh; the noise is drawn
    for the global batch and cut to the rows, and the ``cp`` / ``ring``
    layers split the neighbours over ``context`` (see ``sample_sharded``).
    """
    if injected_noise is None and generator is None:
        raise ValueError("sample needs a generator or injected_noise")
    dev = batch["mask"].device
    graphs = use_graphs(False if injected_noise is not None and graphs is None else graphs, dev)
    if graphs and injected_noise is not None:
        raise ValueError("injected noise runs eagerly: pass graphs=False")
    ts, sched = step_tables(config, num_steps, tables)
    backend = resolve_backend(model_config.backend)
    xs = model_time(backend, ts, config.noise_step_count)
    # the fused backend's chain on the card steps by its kernels, from raw draws
    kernels = backend == "fused" and dev.type == "cuda" and injected_noise is None

    def build(b):
        if backend == "fused":
            return fused_forward(model, b, model_config, bf16)
        if backend == "pallas":
            return pallas_forward(model, b, model_config)
        return dense_forward(model, b, model_config,
                             None if mesh is None else mesh.get_group("context"))

    shape = tuple(batch["mask"].shape)
    rows = None
    if mesh is not None:
        d = mesh.get_coordinate()[0]
        rows = (shape[0] * mesh.size(0), slice(d * shape[0], (d + 1) * shape[0]))

    def drawer(forward: Forward) -> Callable[[torch.Generator], Any]:
        if kernels:
            return lambda g: forward.draw(g, config)
        return lambda g: _noise(g, shape, config, rows)

    with span("sampler.chain"):
        if not graphs:
            forward = build(batch)
            chain = Chain(batch, xs, sched)
            draw = drawer(forward)
            if kernels:
                forward.start(chain)
            for k in range(len(ts)):
                if injected_noise is None:
                    rand = draw(generator)
                else:
                    rf = injected_noise["frames"]
                    rand = {"frames": RigidArray(rf.quats[k], rf.trans[k]),
                            "torsions": injected_noise["torsions"][k]}
                chain.step(forward, rand)
            q, t, tors = chain.q, chain.t, chain.tors
        else:
            cache = GraphCache() if graph_cache is None else graph_cache
            key = ("sample", id(model), backend,
                   mode_of(bf16) if backend == "fused" else "fp32", config, model_config,
                   shape, tuple(batch["pocket_mask"].shape), ts.tobytes(), id(mesh))
            with span("sampler.context"):
                entry = cache.get(key)
                if entry is None:
                    own = own_batch(batch)
                    forward = build(own)
                    entry = _Graphed(forward, Chain(own, xs, sched), drawer(forward))
                    cache.put(key, entry)
                else:
                    for dst, src in zip(entry.forward.static, build(batch).static):
                        dst.copy_(src)
                    entry.chain.restart(batch)
                if kernels:
                    entry.forward.start(entry.chain)
                entry.generator.set_state(generator.get_state())
            K, S = len(ts), STEPS_PER_GRAPH
            for n in [S] * (K // S) + ([K % S] if K % S else []):
                entry.run(n)
            generator.set_state(entry.generator.get_state())
            q, t, tors = entry.chain.q.clone(), entry.chain.t.clone(), entry.chain.tors.clone()

    result = dict(batch)
    result["frames"] = RigidArray(q, t)
    result["torsions"] = tors
    return result


def make_sample_sharded(config: DiffusionConfig, model_config: ScoreNetworkConfig, mesh,
                        tables: ScheduleTables | None = None, bf16=False,
                        num_steps: int | None = None, graphs: bool | None = None) -> Callable:
    """The context-parallel sampler on ``mesh`` (requires the ``cp`` or
    ``ring`` backend): ``run(model, batch, generator=None,
    injected_noise=None)`` takes the global batch (and noise) on every
    rank, samples this rank's ``data`` rows (``sample(..., mesh=mesh)``,
    its graphs kept between calls) and returns the global batch sampled,
    on every rank: the dense ``sample`` on the same batch and generator
    state. The global batch must split evenly over ``data``."""
    if resolve_backend(model_config.backend) not in ("cp", "ring"):
        raise ValueError(
            "sharded sampling requires backend 'cp' or 'ring', got "
            f"{model_config.backend!r}")
    cache = GraphCache()

    def run(model: ScoreNetwork, batch: Dict[str, Any], generator: torch.Generator | None = None,
            injected_noise: Dict[str, Any] | None = None) -> Dict[str, Any]:
        G, n = batch["mask"].shape[0], mesh.size(0)
        if G % n:
            raise ValueError(f"batch {G} not divisible by data={n}")
        rows = data_rows(mesh, G)
        if injected_noise is not None:
            rf = injected_noise["frames"]
            injected_noise = {"frames": RigidArray(rf.quats[:, rows], rf.trans[:, rows]),
                              "torsions": injected_noise["torsions"][:, rows]}
        out = sample(model, take_rows(batch, rows), config, model_config, tables, generator,
                     bf16, injected_noise, num_steps, graphs, cache, mesh)
        q, t, tors = out["frames"].quats, out["frames"].trans, out["torsions"]
        local = torch.cat((q.reshape(-1), t.reshape(-1), tors.reshape(-1)))
        full = all_gather_flat(local, mesh.get_group("data"))
        sizes = (q.numel(), t.numel(), tors.numel())
        parts = [torch.cat([p.view(x.shape) for p in ps]) for x, ps in
                 zip((q, t, tors), zip(*(torch.split(r, sizes) for r in full)))]
        result = dict(batch)
        result["frames"] = RigidArray(parts[0], parts[1])
        result["torsions"] = parts[2]
        return result

    return run


def sample_sharded(model: ScoreNetwork, batch: Dict[str, Any], config: DiffusionConfig,
                   model_config: ScoreNetworkConfig, mesh, tables: ScheduleTables | None = None,
                   generator: torch.Generator | None = None, bf16=False,
                   num_steps: int | None = None, injected_noise: Dict[str, Any] | None = None,
                   graphs: bool | None = None) -> Dict[str, Any]:
    """One-shot ``make_sample_sharded``."""
    return make_sample_sharded(config, model_config, mesh, tables, bf16, num_steps, graphs)(
        model, batch, generator, injected_noise)
