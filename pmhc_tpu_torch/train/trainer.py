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
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from pmhc_tpu_torch.data.synthetic import prepare_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, add_noise, diffusion_loss, gen_noise
from pmhc_tpu_torch.diffusion.loss import LOSS_NAMES
from pmhc_tpu_torch.models.score import ScoreNetwork, ScoreNetworkConfig, score_network_forward
from pmhc_tpu_torch.serve import resolve_device
from pmhc_tpu_torch.train.ema import ema_init, ema_update_
from pmhc_tpu_torch.utils.graphs import GraphCache, Step, batch_tensors, own_batch, use_graphs


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
    updates (``updates_next``)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], learning_rate: LearningRate,
                 grad_clip_norm: Optional[float] = None, grad_accum: int = 1,
                 ema_decay: Optional[float] = None):
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
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
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


def _losses(model, batch, t, epsilon, model_config, diffusion_config, tables, bf16):
    """add_noise -> score network -> the per-sample loss components."""
    if tables is None:
        tables = ScheduleTables(diffusion_config)
    dc = diffusion_config
    zt = add_noise(batch, epsilon, t, tables)
    pred = score_network_forward(model, zt, t, model_config, bf16=bf16)
    return diffusion_loss(epsilon, pred, batch["mask"], batch["torsions_mask"],
                          dc.position_loss_weight, dc.rotation_loss_weight, dc.torsion_loss_weight)


def _train_sums(model: ScoreNetwork, optimizer: Adam, batch: Dict[str, Any], t, epsilon,
                update: bool, model_config: ScoreNetworkConfig, diffusion_config: DiffusionConfig,
                tables: ScheduleTables | None, bf16: bool) -> Dict[str, torch.Tensor]:
    """The device work of one train step: losses, gradients and
    ``optimizer.apply_`` (``update`` says whether this micro-batch updates);
    returns the per-batch loss sums."""
    losses = _losses(model, batch, t, epsilon, model_config, diffusion_config, tables, bf16)
    total = torch.sum(losses["total loss"]) / batch["mask"].shape[0]
    # layer 2's node features feed nothing: their parameters get zero gradients
    grads = torch.autograd.grad(total, optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.apply_(grads, update)
    return {k: torch.sum(v.detach()) for k, v in losses.items()}


def train_step(model: ScoreNetwork, optimizer: Adam, batch: Dict[str, Any], t, epsilon,
               *, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
               diffusion_config: DiffusionConfig = DiffusionConfig(),
               tables: ScheduleTables | None = None, bf16: bool = False) -> Dict[str, torch.Tensor]:
    """One optimization step with the timestep ``t`` (int, or a ``[B]``
    tensor) and the noise ``epsilon`` given. ``batch``: the model batch
    (RigidArray frames, masks, features) on the model's device. Returns the
    per-batch sums of the five loss components (device scalars)."""
    update = optimizer.updates_next
    sums = _train_sums(model, optimizer, batch, t, epsilon, update, model_config,
                       diffusion_config, tables, bf16)
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
    index row it gathers from), its timesteps, its loss sums and the step."""

    def __init__(self, batch: Optional[Dict[str, Any]], data, idx: Optional[torch.Tensor], B: int,
                 device: torch.device):
        self.batch, self.data, self.idx = batch, data, idx
        self.t = torch.zeros(B, dtype=torch.int64, device=device)
        self.sums = torch.zeros(len(LOSS_NAMES), dtype=torch.float32, device=device)
        self.step: Optional[Step] = None


class Trainer:
    """The training loop's state: ``train_batch`` takes one optimizer step on a
    loader batch (numpy, tensor-7 frames). Runs on the card unless given
    ``device="cpu"``; with no card it raises. ``params``: a ``ScoreNetwork``
    or its ``state_dict``; by default the weights are drawn from
    ``train_config.seed``. ``bf16`` selects the loop kernels' bf16 mode.
    ``graphs`` (default: on a CUDA device) runs the steps from CUDA graphs
    kept in ``graph_cache``; ``False`` runs them eagerly (debugging, A/B).
    ``eval_batch`` runs eagerly."""

    def __init__(self, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
                 diffusion_config: DiffusionConfig = DiffusionConfig(),
                 train_config: TrainConfig = TrainConfig(),
                 params: ScoreNetwork | Mapping[str, torch.Tensor] | None = None,
                 bf16: bool = False, device=None, graphs: bool | None = None):
        self.device = resolve_device(device)
        self.graphs = use_graphs(graphs, self.device)
        self.graph_cache = GraphCache()
        # fp32 path: no silent TF32 downgrade of torch.matmul or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model_config = model_config
        self.diffusion_config = diffusion_config
        self.train_config = train_config
        self.bf16 = bool(bf16)
        seed = train_config.seed
        if isinstance(params, ScoreNetwork):
            model = params
        else:
            model = ScoreNetwork(model_config, generator=torch.Generator().manual_seed(seed))
            if params is not None:
                model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).train()
        tc = train_config
        self.optimizer = Adam(list(self.model.parameters()), make_learning_rate(tc),
                              tc.grad_clip_norm, tc.grad_accum, tc.ema_decay)
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
    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA of the parameters as a ``state_dict`` (None unless
        ``TrainConfig.ema_decay`` is set)."""
        if self.optimizer.ema is None:
            return None
        return dict(zip((n for n, _ in self.model.named_parameters()), self.optimizer.ema))

    def draw_t(self, batch_size: int):
        """One timestep for the batch (an int), or one per sample (a ``[B]``
        CPU tensor), from the CPU generator."""
        T = self.diffusion_config.noise_step_count
        if self.diffusion_config.t_per_batch:
            return int(torch.randint(0, T, (), generator=self.t_generator))
        return torch.randint(0, T, (batch_size,), generator=self.t_generator)

    def _write_t(self, dst: torch.Tensor) -> None:
        """Draw the step's timesteps into ``dst`` ([B] on the device) with no
        wait for the card: a fill, or a copy from pinned memory."""
        t = self.draw_t(dst.shape[0])
        if isinstance(t, int):
            dst.fill_(t)
        elif dst.device.type == "cuda":
            dst.copy_(t.pin_memory(), non_blocking=True)
        else:
            dst.copy_(t)

    def _sums(self, batch: Dict[str, Any], t: torch.Tensor, update: bool) -> Dict[str, torch.Tensor]:
        """The step body: noise, the train step's device work, the NaN flag."""
        B, N = batch["mask"].shape
        epsilon = gen_noise(self.noise_generator, (B, N), self.diffusion_config)
        sums = _train_sums(self.model, self.optimizer, batch, t, epsilon, update,
                           self.model_config, self.diffusion_config, self.tables, self.bf16)
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
                sums = self._sums(batch, entry.t, update)
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
        if every and self.global_step % every == 0 and bool(self._nan):
            raise RuntimeError("NaN loss")

    def _replay(self, entry: _TrainGraph) -> Dict[str, torch.Tensor]:
        self._write_t(entry.t)
        entry.step()
        return dict(zip(LOSS_NAMES, entry.sums.clone().unbind()))

    def train_batch(self, batch: Dict[str, Any], metrics=None) -> Dict[str, torch.Tensor]:
        """One optimization step on a loader batch; returns the per-batch
        loss sums (device scalars). Raises ``RuntimeError("NaN loss")``
        at the periodic check if any step since the last one gave NaN."""
        model_batch = prepare_batch(batch, self.device)
        B = model_batch["mask"].shape[0]
        update = self.optimizer.updates_next
        if self.graphs:
            entry = self._graph(("batch", _signature(model_batch)),
                                lambda: _TrainGraph(own_batch(model_batch), None, None, B, self.device),
                                update)
            for dst, src in zip(batch_tensors(entry.batch), batch_tensors(model_batch)):
                dst.copy_(src)
            sums = self._replay(entry)
        else:
            t = torch.empty(B, dtype=torch.int64, device=self.device)
            self._write_t(t)
            sums = self._sums(model_batch, t, update)
        self._finish(sums, B, update, metrics)
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
        ``data.get_batch(row)``."""
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        if idx.ndim != 2:
            raise ValueError(f"train_indices takes a [K, B] index matrix, got shape {tuple(idx.shape)}")
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(self.device, non_blocking=True)
        K, B = idx.shape
        out = []
        for k in range(K):
            update = self.optimizer.updates_next
            if self.graphs:
                entry = self._graph(("indices", data, B),
                                    lambda: _TrainGraph(None, data, idx[k].clone(), B, self.device),
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
        ``ema_params``) replaces the trained weights."""
        model_batch = prepare_batch(batch, self.device)
        B, N = model_batch["mask"].shape
        t = torch.randint(0, self.diffusion_config.noise_step_count, (B,), generator=generator,
                          device=generator.device).to(self.device)
        epsilon = gen_noise(generator, (B, N), self.diffusion_config)
        model = self.model
        if params is not None:
            if self._eval_model is None:
                self._eval_model = ScoreNetwork(self.model_config).to(self.device)
            self._eval_model.load_state_dict(params, strict=True)
            model = self._eval_model
        sums = eval_step(model, model_batch, t, epsilon, model_config=self.model_config,
                         diffusion_config=self.diffusion_config, tables=self.tables, bf16=self.bf16)
        if metrics is not None:
            metrics.add_batch(sums, B)
        return sums

    def save(self, path: str) -> None:
        """Write the weights as a reference-format ``.pth`` state dict,
        replacing the file."""
        save_state_dict(self.model.state_dict(), path)

    def checkpoint_state(self) -> Dict[str, Any]:
        """Everything a resume needs: weights, optimizer state (moments,
        counters, EMA), both generators' states and the step."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "t_generator": self.t_generator.get_state(),
                "noise_generator": self.noise_generator.get_state(), "step": self.global_step}

    def load_checkpoint_state(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.t_generator.set_state(state["t_generator"])
        self.noise_generator.set_state(state["noise_generator"])
        self.global_step = int(state["step"])
