"""The single-GPU training step and the ``Trainer`` around it.

Counterpart of ``pmhc_tpu/train/trainer.py`` (``TrainConfig``,
``make_learning_rate``, the step of ``_build_step_fn``, ``Trainer``):

    batch -> add_noise(t, epsilon) -> score network -> diffusion_loss
          -> backward -> [global-norm clip] -> Adam -> [EMA]

With the ``"fused"`` backend (the default here, as ``auto`` on the TPU)
both EGNN layers run the neighbour-loop kernels forward and backward
(``ops/egnn_loop.py``): two forward-loop and two backward-loop launches
per step. The timestep is drawn once per batch (the reference's quirk)
unless ``DiffusionConfig.t_per_batch`` is False, from a CPU
``torch.Generator`` (an int needs no device sync); the noise comes from a
generator on the trainer's device. The NaN-loss abort is checked every
``nan_check_every`` steps from a flag kept on the device. The optimizer is
``Adam``: optax's Adam formula, optionally behind optax's global-norm
clipping and gradient accumulation (``optax.MultiSteps``, a running mean
over ``grad_accum`` micro-batches; the learning-rate schedule counts
optimizer updates), with the EMA of the parameters after each update.
``eval_step`` / ``Trainer.eval_batch`` compute the same loss sums with no
gradient (the loop kernels run forward only); ``train_batches`` takes K
steps, one per batch; ``train_indices`` takes K steps on batches it
gathers on the device from a ``DeviceDataset``.

The step is one body (``_train_sums``): the timesteps are a ``[B]`` device
tensor, and Adam's learning rate (its schedule included) and bias
corrections are computed on the device from an update count kept there,
as optax does. On the card it runs from CUDA graphs (``utils/graphs.py``),
the counterpart of the JAX package's jitted step and of its K-step scans
(``make_train_scan``, ``make_train_scan_device``): one graph per batch
shape (two with ``grad_accum`` above 1: a micro-batch that only
accumulates, and one that updates), captured at its first step and then
replayed once a step after the batch is copied into its static inputs and
the timesteps drawn from the CPU generator are written there. The NaN flag
is updated inside the graph and read outside it. ``graphs=False`` runs the
same body eagerly (the CPU always does).

On a mesh (``mesh=``, ``parallel/mesh.py::make_mesh``; one process per
GPU) a step equals the single-device step on the same global batch and
seed, as the JAX package's sharded step does. ``train_batch`` takes the
global batch on every rank and keeps its ``data`` rows; every rank draws
the global timesteps and noise from the same generators and keeps its
rows; the loss is its rows' sum over the global batch size. All the
gradients and the five loss sums go in one flat buffer and one all-reduce
over ``data`` (with ``context_parallel`` then one over ``context``,
divided by its size: ``parallel/comm.py``); clipping, Adam and the EMA
then run replicated, and the NaN flag reads the reduced sums. With
``tensor_parallel`` the MLPs' weights, Adam moments and EMA are split
over ``model`` (``tp_shard_``), the clipping norm sums the split tensors'
squares over ``model``, and the files hold the whole tensors, gathered.
Only rank 0 writes. On the card the all-reduces are captured in the
step's graph.

Spans (``utils/profiling.py``): ``trainer.call`` around a ``train_batch`` or
``train_indices`` call; in it ``trainer.step`` per optimizer step (id: the
step's number, ``global_step`` after it), which holds ``trainer.replay``
(launching the step's graph) and, on the steps that check,
``trainer.nan_check`` (the host's wait for the NaN flag).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from pmhc_tpu_torch.data.synthetic import prepare_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, add_noise, diffusion_loss, gen_noise
from pmhc_tpu_torch.diffusion.loss import LOSS_NAMES
from pmhc_tpu_torch.models.score import (
    ScoreNetwork,
    ScoreNetworkConfig,
    resolve_backend,
    score_network_forward,
)
from pmhc_tpu_torch.parallel.mesh import (
    data_rows,
    replicate_,
    take_rows,
    tp_gather,
    tp_shard_,
    tp_shard_dim,
    tp_take,
)
from pmhc_tpu_torch.serve import resolve_device
from pmhc_tpu_torch.train.ema import ema_init, ema_update_
from pmhc_tpu_torch.utils.graphs import GraphCache, Step, batch_tensors, own_batch, use_graphs
from pmhc_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class TrainConfig:
    """Defaults are the reference CLI's (``optimize.py:29-32``); the
    extensions (clipping, EMA, schedule, accumulation) are off."""

    learning_rate: float = 1e-3
    batch_size: int = 64
    checkpoint_every_batches: int = 100
    nan_check_every: int = 100
    seed: int = 0
    grad_clip_norm: float | None = None
    ema_decay: float | None = None
    lr_warmup_steps: int = 0
    lr_decay_steps: int | None = None
    lr_final: float = 0.0
    grad_accum: int = 1


LearningRate = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def make_learning_rate(config: TrainConfig) -> LearningRate:
    """The learning rate: a float when no schedule is asked for, else a
    function of the optimizer-update count (a float32 tensor on any
    device, or an int) in tensor ops, with optax's formulas in float32
    (``warmup_cosine_decay_schedule``, or ``join_schedules`` of
    ``linear_schedule`` and ``constant_schedule``): linear warmup from 0,
    then constant or cosine decay to ``lr_final`` over the total horizon
    ``lr_decay_steps``."""
    if not config.lr_warmup_steps and config.lr_decay_steps is None:
        return config.learning_rate
    warmup, peak = config.lr_warmup_steps, config.learning_rate
    if config.lr_decay_steps is not None and config.lr_decay_steps <= warmup:
        raise ValueError(f"lr_decay_steps ({config.lr_decay_steps}) must exceed "
                         f"lr_warmup_steps ({warmup}) — it is the total horizon")
    decay = config.lr_decay_steps

    def after_warmup(count: torch.Tensor) -> torch.Tensor:
        if decay is None:
            return torch.full_like(count, peak)
        span = float(decay - warmup)
        alpha = 0.0 if peak == 0.0 else config.lr_final / peak
        c = torch.clamp(count - warmup, max=span)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / span))
        return peak * ((1.0 - alpha) * cosine + alpha)

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.float32)
        if not warmup:
            return after_warmup(count)
        frac = 1.0 - torch.clamp(count, 0.0, float(warmup)) / warmup
        return torch.where(count < warmup, (0.0 - peak) * frac + peak, after_warmup(count))

    return schedule


class Adam:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8, bias correction in
    float32) on a list of parameters, updated in place:
    ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``. Before it, optionally
    optax's ``clip_by_global_norm`` (scale by max_norm / norm when norm >=
    max_norm) and ``MultiSteps`` accumulation; after it, the EMA.

    The update count (optax's ``count``) and the accumulation's micro-batch
    count live on the parameters' device, so ``apply_`` reads no host
    value that changes between steps and a CUDA graph can replay it; the
    host keeps ``mini_step`` too, which says whether a micro-batch
    updates (``updates_next``). Under tensor parallelism ``tp_group`` is
    the ``model`` group and ``tp_split`` says which parameters are split
    over it: the clipping norm sums their squares over the group and
    counts the replicated ones once."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], learning_rate: LearningRate,
                 grad_clip_norm: Optional[float] = None, grad_accum: int = 1,
                 ema_decay: Optional[float] = None, tp_group=None,
                 tp_split: Optional[List[bool]] = None):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.params = list(params)
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.grad_accum = grad_accum
        self.ema_decay = ema_decay
        dev = self.params[0].device
        self.count_t = torch.zeros((), dtype=torch.int32, device=dev)  # optimizer updates
        self.mini_step = 0   # micro-batches in the current accumulation
        self.mini_t = torch.zeros((), dtype=torch.float32, device=dev)  # the same, on the device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if grad_accum > 1 else None
        self.ema = ema_init(self.params) if ema_decay else None
        self.tp_group = tp_group
        self.tp_split = None if tp_split is None else \
            torch.tensor(tp_split, dtype=torch.float32, device=dev)

    @property
    def count(self) -> int:
        """Optimizer updates so far (reads the device)."""
        return int(self.count_t)

    @property
    def updates_next(self) -> bool:
        """Whether the next micro-batch updates the parameters."""
        return self.mini_step + 1 >= self.grad_accum

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Feed one micro-batch's gradients; returns True when the
        parameters were updated."""
        update = self.updates_next
        self.apply_(grads, update)
        self.advance(update)
        return update

    def advance(self, update: bool) -> None:
        """The host's side of a micro-batch that ``apply_`` took."""
        self.mini_step = 0 if update else self.mini_step + 1

    @torch.no_grad()
    def apply_(self, grads: List[torch.Tensor], update: bool) -> None:
        """The device work of one micro-batch: accumulate, and with
        ``update`` clip, step and average. It reads the counts on the
        device and writes every state tensor in place."""
        grads = list(grads)
        if self.acc is not None:
            # running mean (Welford): acc += (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, self.mini_t + 1.0)
            torch._foreach_add_(self.acc, delta)
            if not update:
                self.mini_t += 1.0
                return
            grads = self.acc
        if self.grad_clip_norm:
            norms = torch.stack(torch._foreach_norm(grads))
            if self.tp_group is None:
                norm = torch.linalg.vector_norm(norms)
            else:
                sq = norms * norms
                split = torch.sum(sq * self.tp_split)
                dist.all_reduce(split, group=self.tp_group)
                norm = torch.sqrt(split + torch.sum(sq * (1.0 - self.tp_split)))
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        count = self.count_t.float()
        lr = self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate
        bc1 = 1.0 - torch.pow(self.B1, count + 1.0)
        bc2 = 1.0 - torch.pow(self.B2, count + 1.0)
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.B2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        self.count_t += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
            self.mini_t.zero_()
        if self.ema is not None:
            ema_update_(self.ema, self.params, self.ema_decay)

    @torch.no_grad()
    def reset_(self) -> None:
        """A fresh state, in place: moments, counts and accumulator zeroed,
        the EMA restarted from the current weights."""
        zero = self.mu + self.nu + (self.acc or [])
        torch._foreach_zero_(zero)
        self.count_t.zero_()
        self.mini_t.zero_()
        self.mini_step = 0
        if self.ema is not None:
            torch._foreach_copy_(self.ema, [p.detach() for p in self.params])

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu,
                "acc": self.acc, "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.mini_step = int(state["mini_step"])
        self.count_t.fill_(int(state["count"]))
        self.mini_t.fill_(float(self.mini_step))
        for name in ("mu", "nu", "acc", "ema"):
            mine, theirs = getattr(self, name), state[name]
            if (mine is None) != (theirs is None):
                raise ValueError(f"optimizer state {name!r} does not match this configuration")
            if mine is not None:
                torch._foreach_copy_(mine, [t.to(m.device) for m, t in zip(mine, theirs)])


def _losses(model, batch, t, epsilon, model_config, diffusion_config, tables, bf16,
            context_group=None):
    """add_noise -> score network -> the per-sample loss components."""
    if tables is None:
        tables = ScheduleTables(diffusion_config)
    dc = diffusion_config
    zt = add_noise(batch, epsilon, t, tables)
    pred = score_network_forward(model, zt, t, model_config, bf16=bf16,
                                 context_group=context_group)
    return diffusion_loss(epsilon, pred, batch["mask"], batch["torsions_mask"],
                          dc.position_loss_weight, dc.rotation_loss_weight, dc.torsion_loss_weight)


def _train_sums(model: ScoreNetwork, optimizer: Adam, batch: Dict[str, Any], t, epsilon,
                update: bool, model_config: ScoreNetworkConfig, diffusion_config: DiffusionConfig,
                tables: ScheduleTables | None, bf16: bool, mesh=None, global_batch: int = 0,
                context_parallel: bool = False) -> Dict[str, torch.Tensor]:
    """The device work of one train step: losses, gradients and
    ``optimizer.apply_`` (``update`` says whether this micro-batch updates);
    returns the per-batch loss sums. On a ``mesh``, ``batch`` is this
    rank's rows of a batch of ``global_batch`` and the gradients and sums
    are reduced over the mesh (``_reduce``)."""
    context_group = mesh.get_group("context") if context_parallel else None
    losses = _losses(model, batch, t, epsilon, model_config, diffusion_config, tables, bf16,
                     context_group)
    total = torch.sum(losses["total loss"]) / (global_batch or batch["mask"].shape[0])
    # layer 2's node features feed nothing: their parameters get zero gradients
    grads = torch.autograd.grad(total, optimizer.params, allow_unused=True, materialize_grads=True)
    sums = torch.stack([torch.sum(losses[k].detach()) for k in LOSS_NAMES])
    if mesh is not None:
        grads, sums = _reduce(list(grads), sums, mesh, context_parallel)
    optimizer.apply_(grads, update)
    return dict(zip(LOSS_NAMES, sums.unbind()))


def _reduce(grads: List[torch.Tensor], sums: torch.Tensor, mesh, context_parallel: bool):
    """The gradients and loss sums of every rank, in one flat buffer: one
    all-reduce over ``data``; with ``context_parallel`` one over ``context``
    too, divided by its size (each context rank's gradients are right on
    average, ``parallel/comm.py``)."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [sums])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    if context_parallel and mesh.size(2) > 1:
        dist.all_reduce(flat, group=mesh.get_group("context"))
        flat = flat / mesh.size(2)
    parts = torch.split(flat, [g.numel() for g in grads] + [sums.numel()])
    return [p.view_as(g) for p, g in zip(parts, grads)], parts[-1]


def train_step(model: ScoreNetwork, optimizer: Adam, batch: Dict[str, Any], t, epsilon,
               *, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
               diffusion_config: DiffusionConfig = DiffusionConfig(),
               tables: ScheduleTables | None = None, bf16: bool = False, mesh=None,
               global_batch: int = 0, context_parallel: bool = False) -> Dict[str, torch.Tensor]:
    """One optimization step with the timestep ``t`` (int, or a ``[B]``
    tensor) and the noise ``epsilon`` given. ``batch``: the model batch
    (RigidArray frames, masks, features) on the model's device. Returns the
    per-batch sums of the five loss components (device scalars). On a
    ``mesh``, ``batch``, ``t`` and ``epsilon`` are this rank's rows of a
    batch of ``global_batch``, and the sums are the global batch's."""
    update = optimizer.updates_next
    sums = _train_sums(model, optimizer, batch, t, epsilon, update, model_config,
                       diffusion_config, tables, bf16, mesh, global_batch, context_parallel)
    optimizer.advance(update)
    return sums


@torch.no_grad()
def eval_step(model: ScoreNetwork, batch: Dict[str, Any], t, epsilon,
              *, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
              diffusion_config: DiffusionConfig = DiffusionConfig(),
              tables: ScheduleTables | None = None, bf16: bool = False) -> Dict[str, torch.Tensor]:
    """The train step's loss sums with no gradient and no update (the loop
    kernels run forward only)."""
    losses = _losses(model, batch, t, epsilon, model_config, diffusion_config, tables, bf16)
    return {k: torch.sum(v) for k, v in losses.items()}


def save_state_dict(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a reference-format ``.pth`` state dict, replacing the file."""
    state = {k: v.detach().cpu().contiguous() for k, v in state.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _signature(batch: Dict[str, Any]) -> tuple:
    """Keys, shapes and types of a model batch (part of a graph's key)."""
    return tuple(sorted(batch)) + tuple((tuple(x.shape), x.dtype) for x in batch_tensors(batch))


class _TrainGraph:
    """One captured train step: its static model batch (or the dataset and
    index row it gathers from), its timesteps, its loss sums and the step;
    on a mesh the global batch size and this rank's rows of it."""

    def __init__(self, batch: Optional[Dict[str, Any]], data, idx: Optional[torch.Tensor], B: int,
                 device: torch.device, global_batch: int = 0, rows: Optional[slice] = None):
        self.batch, self.data, self.idx = batch, data, idx
        self.global_batch, self.rows = global_batch or B, rows
        self.t = torch.zeros(B, dtype=torch.int64, device=device)
        self.sums = torch.zeros(len(LOSS_NAMES), dtype=torch.float32, device=device)
        self.step: Optional[Step] = None


class Trainer:
    """The training loop's state: ``train_batch`` takes one optimizer step on a
    loader batch (numpy, tensor-7 frames). Runs on the card unless given
    ``device="cpu"``; with no card it raises. ``params``: a ``ScoreNetwork``
    or its ``state_dict``; by default the weights are drawn from
    ``train_config.seed``. ``bf16`` selects the loop kernels' bf16 mode,
    ``fast_f32`` their high mode (``--fast-f32``: products split into bf16
    halves; ``bf16`` wins if both are asked, as in the JAX package; the
    other backends run fp32 whatever is asked).
    ``graphs`` (default: on a CUDA device) runs the steps from CUDA graphs
    kept in ``graph_cache``; ``False`` runs them eagerly (debugging, A/B).
    ``eval_batch`` runs eagerly.

    ``mesh`` (a ``make_mesh`` mesh this rank is on; the device is the
    mesh's) runs the steps data-parallel over its ``data`` axis (see the
    module's docstring). ``tensor_parallel`` splits the MLPs over ``model``;
    ``context_parallel`` splits the neighbour axis over ``context`` and
    needs the ``cp`` or ``ring`` backend; both together need the ``xla``
    (dense) backend, as in the JAX package, and run the ``cp`` layer with
    Megatron MLPs. ``train_indices`` runs on one device only."""

    def __init__(self, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
                 diffusion_config: DiffusionConfig = DiffusionConfig(),
                 train_config: TrainConfig = TrainConfig(),
                 params: ScoreNetwork | Mapping[str, torch.Tensor] | None = None,
                 bf16: bool = False, fast_f32: bool = False, device=None,
                 graphs: bool | None = None, mesh=None, tensor_parallel: bool = False,
                 context_parallel: bool = False):
        from pmhc_tpu_torch.models.structure import StructureNetwork, StructureNetworkConfig

        if isinstance(model_config, StructureNetworkConfig) or isinstance(params,
                                                                          StructureNetwork):
            raise ValueError("the structure network samples only: the Trainer trains the EGNN")
        backend = resolve_backend(model_config.backend)
        self.forward_config = model_config
        if context_parallel and tensor_parallel:
            if mesh is None:
                raise ValueError("context_parallel requires a mesh")
            if backend != "dense":
                raise ValueError(
                    "DP x TP x CP runs as one GSPMD jit over the xla backend "
                    "(neighbour-axis sharding constraints compose with the "
                    "Megatron layout); set ScoreNetworkConfig.backend='xla', "
                    f"got {model_config.backend!r}")
            # the port's DP x TP x CP: the cp layer with Megatron MLPs
            self.forward_config = replace(model_config, backend="cp")
        elif context_parallel:
            if mesh is None:
                raise ValueError("context_parallel requires a mesh")
            if backend not in ("cp", "ring"):
                raise ValueError("context_parallel requires ScoreNetworkConfig.backend "
                                 f"'cp' or 'ring', got {model_config.backend!r}")
        if tensor_parallel and mesh is None:
            raise ValueError("tensor_parallel requires a mesh")
        self.mesh = mesh
        self.tensor_parallel = bool(tensor_parallel)
        self.context_parallel = bool(context_parallel)
        if mesh is not None:
            if mesh.get_coordinate() is None:
                raise ValueError(f"rank {dist.get_rank()} is not on the mesh {tuple(mesh.shape)}")
            dev = torch.device(mesh.device_type)
            if dev.type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            if device is not None and torch.device(device).type != dev.type:
                raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
            device = dev
        self.device = resolve_device(device)
        # only rank 0 writes files
        self.writer = mesh is None or dist.get_rank() == 0
        self.graphs = use_graphs(graphs, self.device)
        self.graph_cache = GraphCache()
        # fp32 path: no silent TF32 downgrade of torch.matmul or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model_config = model_config
        self.diffusion_config = diffusion_config
        self.train_config = train_config
        # the loop kernels' mode in the JAX package's convention (mode_of)
        self.mode = True if bf16 else "high" if fast_f32 else False
        seed = train_config.seed
        if isinstance(params, ScoreNetwork):
            model = params
        else:
            model = ScoreNetwork(model_config, generator=torch.Generator().manual_seed(seed))
            if params is not None:
                model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).train()
        self._names = [n for n, _ in self.model.named_parameters()]
        tp = {}
        if mesh is not None:
            replicate_(list(self.model.parameters()), mesh)
            if tensor_parallel:
                tp_shard_(self.model, mesh)
                tp = {"tp_group": mesh.get_group("model"),
                      "tp_split": [tp_shard_dim(n) is not None for n in self._names]}
        tc = train_config
        self.optimizer = Adam(list(self.model.parameters()), make_learning_rate(tc),
                              tc.grad_clip_norm, tc.grad_accum, tc.ema_decay, **tp)
        self.tables = ScheduleTables(diffusion_config)
        self.t_generator = torch.Generator()
        self.noise_generator = torch.Generator(device=self.device)
        self.reseed(seed)
        self.global_step = 0
        self._nan = torch.zeros((), dtype=torch.bool, device=self.device)
        self._eval_model: Optional[ScoreNetwork] = None

    def reset_optimizer(self) -> None:
        """A fresh optimizer state: Adam moments, counters, accumulator and
        EMA (restarted from the current weights), reset in place, where the
        captured steps read them."""
        self.optimizer.reset_()

    def reseed(self, seed: int) -> None:
        """Seed the timestep generator with ``seed`` and the noise generator
        with ``seed + 1``."""
        self.t_generator.manual_seed(seed)
        self.noise_generator.manual_seed(seed + 1)

    @property
    def precision(self) -> str:
        """The precision the layers run at: ``"bf16"`` or ``"fast-f32"``
        only on the fused backend asked for it, else ``"f32"``."""
        if resolve_backend(self.model_config.backend) != "fused":
            return "f32"
        return {True: "bf16", "high": "fast-f32", False: "f32"}[self.mode]

    def _whole(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` (parameters, or state that mirrors them) whole: under
        tensor parallelism gathered over ``model`` (every rank calls it)."""
        if not self.tensor_parallel:
            return tensors
        return tp_gather(self._names, tensors, self.mesh)

    def _parts(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's parts of whole ``tensors`` (the inverse of ``_whole``)."""
        if not self.tensor_parallel:
            return tensors
        return tp_take(self._names, tensors, self.mesh)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights as a reference ``state_dict`` (whole tensors)."""
        if not self.tensor_parallel:
            return self.model.state_dict()
        return dict(zip(self._names, self._whole(list(self.model.parameters()))))

    @torch.no_grad()
    def load_weights(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load a reference ``state_dict`` (whole tensors; strict)."""
        if not self.tensor_parallel:
            self.model.load_state_dict(state, strict=True)
            return
        if set(state) != set(self._names):
            raise ValueError(f"state dict keys differ from the model's: "
                             f"{sorted(set(state) ^ set(self._names))}")
        torch._foreach_copy_(list(self.model.parameters()),
                             [t.to(self.device) for t in self._parts([state[n] for n in self._names])])

    @property
    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA of the parameters as a ``state_dict`` (None unless
        ``TrainConfig.ema_decay`` is set); whole tensors."""
        if self.optimizer.ema is None:
            return None
        return dict(zip(self._names, self._whole(self.optimizer.ema)))

    def draw_t(self, batch_size: int):
        """One timestep for the batch (an int), or one per sample (a ``[B]``
        CPU tensor), from the CPU generator."""
        T = self.diffusion_config.noise_step_count
        if self.diffusion_config.t_per_batch:
            return int(torch.randint(0, T, (), generator=self.t_generator))
        return torch.randint(0, T, (batch_size,), generator=self.t_generator)

    def _write_t(self, dst: torch.Tensor, global_batch: int = 0, rows: Optional[slice] = None) -> None:
        """Draw the step's timesteps into ``dst`` ([B] on the device) with no
        wait for the card: a fill, or a copy from pinned memory. On a mesh
        the global batch's are drawn and ``rows`` of them kept."""
        t = self.draw_t(global_batch or dst.shape[0])
        if isinstance(t, int):
            dst.fill_(t)
            return
        if rows is not None:
            t = t[rows]
        if dst.device.type == "cuda":
            dst.copy_(t.pin_memory(), non_blocking=True)
        else:
            dst.copy_(t)

    def _sums(self, batch: Dict[str, Any], t: torch.Tensor, update: bool, global_batch: int = 0,
              rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
        """The step body: noise (the global batch's, ``rows`` of it kept),
        the train step's device work, the NaN flag."""
        B, N = batch["mask"].shape
        epsilon = gen_noise(self.noise_generator, (global_batch or B, N), self.diffusion_config)
        if rows is not None:
            epsilon = take_rows(epsilon, rows)
        sums = _train_sums(self.model, self.optimizer, batch, t, epsilon, update,
                           self.forward_config, self.diffusion_config, self.tables, self.mode,
                           self.mesh, global_batch, self.context_parallel)
        self._nan |= torch.isnan(sums["total loss"])
        return sums

    def _graph(self, key: tuple, make: Callable[[], _TrainGraph], update: bool) -> _TrainGraph:
        """The cached graph of ``key`` (one per update kind), made and
        given its step at first use."""
        key = key + (update,)
        entry = self.graph_cache.get(key)
        if entry is None:
            entry = make()

            def body():
                batch = entry.batch if entry.idx is None else self._gather(entry.data, entry.idx)
                sums = self._sums(batch, entry.t, update, entry.global_batch, entry.rows)
                entry.sums.copy_(torch.stack([sums[k] for k in LOSS_NAMES]))

            entry.step = Step(body, [self.noise_generator])
            self.graph_cache.put(key, entry)
        return entry

    def _gather(self, data, idx: torch.Tensor) -> Dict[str, Any]:
        return prepare_batch(data.gather(idx), self.device)

    def _finish(self, sums: Dict[str, torch.Tensor], B: int, update: bool, metrics) -> None:
        """The host's side of a step: counters, metrics, the periodic NaN check."""
        self.optimizer.advance(update)
        self.global_step += 1
        if metrics is not None:
            metrics.add_batch(sums, B)
        every = self.train_config.nan_check_every
        if every and self.global_step % every == 0:
            with span("trainer.nan_check"):
                nan = bool(self._nan)
            if nan:
                raise RuntimeError("NaN loss")

    def _replay(self, entry: _TrainGraph) -> Dict[str, torch.Tensor]:
        self._write_t(entry.t, entry.global_batch, entry.rows)
        with span("trainer.replay"):
            entry.step()
        return dict(zip(LOSS_NAMES, entry.sums.clone().unbind()))

    def _rows(self, batch: Mapping[str, Any]):
        """The global batch size of a loader batch and, on a mesh, this
        rank's rows of it."""
        B = len(batch["mask"])
        return B, (None if self.mesh is None else data_rows(self.mesh, B))

    def train_batch(self, batch: Dict[str, Any], metrics=None) -> Dict[str, torch.Tensor]:
        """One optimization step on a loader batch; returns the per-batch
        loss sums (device scalars). Raises ``RuntimeError("NaN loss")``
        at the periodic check if any step since the last one gave NaN. On a
        mesh ``batch`` is the global batch, the same on every rank."""
        with span("trainer.call"), span("trainer.step", self.global_step + 1):
            G, rows = self._rows(batch)
            model_batch = prepare_batch(batch if rows is None else take_rows(batch, rows),
                                        self.device)
            B = model_batch["mask"].shape[0]
            update = self.optimizer.updates_next
            if self.graphs:
                entry = self._graph(("batch", _signature(model_batch), G),
                                    lambda: _TrainGraph(own_batch(model_batch), None, None, B,
                                                        self.device, G, rows),
                                    update)
                for dst, src in zip(batch_tensors(entry.batch), batch_tensors(model_batch)):
                    dst.copy_(src)
                sums = self._replay(entry)
            else:
                t = torch.empty(B, dtype=torch.int64, device=self.device)
                self._write_t(t, G, rows)
                sums = self._sums(model_batch, t, update, G, rows)
            self._finish(sums, G, update, metrics)
        return sums

    def train_batches(self, batches, metrics=None) -> List[Dict[str, torch.Tensor]]:
        """K optimizer steps, one per batch in order: the same math as K
        ``train_batch`` calls (on the card, K replays of the step's graph)."""
        return [self.train_batch(b, metrics) for b in batches]

    def train_indices(self, data, idx, metrics=None) -> List[Dict[str, torch.Tensor]]:
        """K optimizer steps on batches gathered on the device from the
        ``DeviceDataset`` ``data`` by the rows of ``idx`` ([K, B] entry
        indices): the counterpart of the JAX package's
        ``make_train_scan_device``. The index matrix crosses to the card
        once; on the card each step is one replay of a graph that gathers
        its row and steps. The same math as K ``train_batch`` calls on
        ``data.get_batch(row)``. One device only, as in the JAX package."""
        if self.mesh is not None:
            raise ValueError("train_indices runs on one device; on a mesh use train_batch")
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        if idx.ndim != 2:
            raise ValueError(f"train_indices takes a [K, B] index matrix, got shape {tuple(idx.shape)}")
        with span("trainer.call"):
            if self.device.type == "cuda":
                idx = idx.pin_memory()
            idx = idx.to(self.device, non_blocking=True)
            K, B = idx.shape
            out = []
            for k in range(K):
                with span("trainer.step", self.global_step + 1):
                    update = self.optimizer.updates_next
                    if self.graphs:
                        entry = self._graph(("indices", data, B),
                                            lambda: _TrainGraph(None, data, idx[k].clone(), B,
                                                                self.device),
                                            update)
                        entry.idx.copy_(idx[k])
                        sums = self._replay(entry)
                    else:
                        t = torch.empty(B, dtype=torch.int64, device=self.device)
                        self._write_t(t)
                        sums = self._sums(self._gather(data, idx[k]), t, update)
                    self._finish(sums, B, update, metrics)
                out.append(sums)
        return out

    def eval_batch(self, batch: Dict[str, Any], generator: torch.Generator, metrics=None,
                   params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Held-out loss sums on a loader batch: no gradient, no update.
        ``t`` is drawn per sample and the noise comes from ``generator`` (on
        the trainer's device), so the same generator seed per batch index
        gives an epoch-comparable curve. ``params`` (a ``state_dict``, e.g.
        ``ema_params``) replaces the trained weights. On a mesh each rank
        evaluates its rows of the global draws and the sums are reduced over
        ``data``; ``cp`` and ``ring`` evaluate with the dense layer, as in
        the JAX package."""
        G, rows = self._rows(batch)
        model_batch = prepare_batch(batch if rows is None else take_rows(batch, rows), self.device)
        N = model_batch["mask"].shape[1]
        t = torch.randint(0, self.diffusion_config.noise_step_count, (G,), generator=generator,
                          device=generator.device).to(self.device)
        epsilon = gen_noise(generator, (G, N), self.diffusion_config)
        if rows is not None:
            t, epsilon = t[rows], take_rows(epsilon, rows)
        model = self.model
        if params is not None:
            if self._eval_model is None or self.tensor_parallel:
                self._eval_model = ScoreNetwork(self.model_config).to(self.device)
            self._eval_model.load_state_dict(params, strict=True)
            if self.tensor_parallel:
                tp_shard_(self._eval_model, self.mesh)
            model = self._eval_model
        config = self.model_config
        if resolve_backend(config.backend) in ("cp", "ring"):
            config = replace(config, backend="dense")
        sums = eval_step(model, model_batch, t, epsilon, model_config=config,
                         diffusion_config=self.diffusion_config, tables=self.tables, bf16=self.mode)
        if self.mesh is not None:
            flat = torch.stack([sums[k] for k in LOSS_NAMES])
            dist.all_reduce(flat, group=self.mesh.get_group("data"))
            sums = dict(zip(LOSS_NAMES, flat.unbind()))
        if metrics is not None:
            metrics.add_batch(sums, G)
        return sums

    def save(self, path: str) -> None:
        """Write the weights as a reference-format ``.pth`` state dict,
        replacing the file (on a mesh every rank calls it, rank 0 writes)."""
        state = self.state_dict()
        if self.writer:
            save_state_dict(state, path)

    def checkpoint_state(self) -> Dict[str, Any]:
        """Everything a resume needs: weights, optimizer state (moments,
        counters, EMA), both generators' states and the step; whole
        tensors (on a mesh every rank calls it)."""
        opt = self.optimizer.state_dict()
        for k in ("mu", "nu", "acc", "ema"):
            if opt[k] is not None:
                opt[k] = self._whole(opt[k])
        return {"model": self.state_dict(), "optimizer": opt,
                "t_generator": self.t_generator.get_state(),
                "noise_generator": self.noise_generator.get_state(), "step": self.global_step}

    def load_checkpoint_state(self, state: Mapping[str, Any]) -> None:
        self.load_weights(state["model"])
        opt = dict(state["optimizer"])
        for k in ("mu", "nu", "acc", "ema"):
            if opt[k] is not None:
                opt[k] = self._parts(list(opt[k]))
        self.optimizer.load_state_dict(opt)
        self.t_generator.set_state(state["t_generator"])
        self.noise_generator.set_state(state["noise_generator"])
        self.global_step = int(state["step"])
