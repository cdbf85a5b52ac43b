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
steps, one per batch.
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
from pmhc_tpu_torch.models.score import ScoreNetwork, ScoreNetworkConfig, score_network_forward
from pmhc_tpu_torch.serve import resolve_device
from pmhc_tpu_torch.train.ema import ema_init, ema_update_


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


LearningRate = Union[float, Callable[[int], float]]


def make_learning_rate(config: TrainConfig) -> LearningRate:
    """The learning rate: a float when no schedule is asked for, else a
    function of the optimizer-update count with optax's numbers (linear
    warmup from 0, then constant or cosine decay to ``lr_final`` over the
    total horizon ``lr_decay_steps``)."""
    if not config.lr_warmup_steps and config.lr_decay_steps is None:
        return config.learning_rate
    warmup, peak = config.lr_warmup_steps, config.learning_rate
    if config.lr_decay_steps is not None and config.lr_decay_steps <= warmup:
        raise ValueError(f"lr_decay_steps ({config.lr_decay_steps}) must exceed "
                         f"lr_warmup_steps ({warmup}) — it is the total horizon")

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        if config.lr_decay_steps is None:
            return peak
        span = config.lr_decay_steps - warmup
        alpha = 0.0 if peak == 0.0 else config.lr_final / peak
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, span) / span))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Adam:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8, bias correction in
    float32) on a list of parameters, updated in place:
    ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``. Before it, optionally
    optax's ``clip_by_global_norm`` (scale by max_norm / norm when norm >=
    max_norm) and ``MultiSteps`` accumulation; after it, the EMA."""

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
        self.count = 0       # optimizer updates
        self.mini_step = 0   # micro-batches in the current accumulation
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if grad_accum > 1 else None
        self.ema = ema_init(self.params) if ema_decay else None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Feed one micro-batch's gradients; returns True when the
        parameters were updated."""
        grads = list(grads)
        if self.acc is not None:
            # running mean (Welford): acc += (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < self.grad_accum:
                return False
            grads, self.mini_step = self.acc, 0
            self.acc = [torch.zeros_like(p) for p in self.params]
        if self.grad_clip_norm:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.lr(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.B1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(self.B2) ** f32(self.count))
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.B2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if self.ema is not None:
            ema_update_(self.ema, self.params, self.ema_decay)
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu,
                "acc": self.acc, "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
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


def train_step(model: ScoreNetwork, optimizer: Adam, batch: Dict[str, Any], t, epsilon,
               *, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
               diffusion_config: DiffusionConfig = DiffusionConfig(),
               tables: ScheduleTables | None = None, bf16: bool = False) -> Dict[str, torch.Tensor]:
    """One optimization step with the timestep ``t`` (int, or a ``[B]``
    tensor) and the noise ``epsilon`` given. ``batch``: the model batch
    (RigidArray frames, masks, features) on the model's device. Returns the
    per-batch sums of the five loss components (device scalars)."""
    losses = _losses(model, batch, t, epsilon, model_config, diffusion_config, tables, bf16)
    total = torch.sum(losses["total loss"]) / batch["mask"].shape[0]
    # layer 2's node features feed nothing: their parameters get zero gradients
    grads = torch.autograd.grad(total, optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.step(grads)
    return {k: torch.sum(v.detach()) for k, v in losses.items()}


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


class Trainer:
    """The training loop's state: ``train_batch`` takes one optimizer step on a
    loader batch (numpy, tensor-7 frames). Runs on the card unless given
    ``device="cpu"``; with no card it raises. ``params``: a ``ScoreNetwork``
    or its ``state_dict``; by default the weights are drawn from
    ``train_config.seed``. ``bf16`` selects the loop kernels' bf16 mode."""

    def __init__(self, model_config: ScoreNetworkConfig = ScoreNetworkConfig(backend="auto"),
                 diffusion_config: DiffusionConfig = DiffusionConfig(),
                 train_config: TrainConfig = TrainConfig(),
                 params: ScoreNetwork | Mapping[str, torch.Tensor] | None = None,
                 bf16: bool = False, device=None):
        self.device = resolve_device(device)
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
        self.reset_optimizer()
        self.tables = ScheduleTables(diffusion_config)
        self.t_generator = torch.Generator()
        self.noise_generator = torch.Generator(device=self.device)
        self.reseed(seed)
        self.global_step = 0
        self._nan = torch.zeros((), dtype=torch.bool, device=self.device)
        self._eval_model: Optional[ScoreNetwork] = None

    def reset_optimizer(self) -> None:
        """A fresh optimizer: Adam moments, counters, accumulator and EMA
        (the EMA restarts from the current weights)."""
        tc = self.train_config
        self.optimizer = Adam(list(self.model.parameters()), make_learning_rate(tc),
                              tc.grad_clip_norm, tc.grad_accum, tc.ema_decay)

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
        """One timestep for the batch (an int), or one per sample."""
        T = self.diffusion_config.noise_step_count
        if self.diffusion_config.t_per_batch:
            return int(torch.randint(0, T, (), generator=self.t_generator))
        return torch.randint(0, T, (batch_size,), generator=self.t_generator).to(self.device)

    def train_batch(self, batch: Dict[str, Any], metrics=None) -> Dict[str, torch.Tensor]:
        """One optimization step on a loader batch; returns the per-batch
        loss sums (device scalars). Raises ``RuntimeError("NaN loss")``
        at the periodic check if any step since the last one gave NaN."""
        model_batch = prepare_batch(batch, self.device)
        B, N = model_batch["mask"].shape
        t = self.draw_t(B)
        epsilon = gen_noise(self.noise_generator, (B, N), self.diffusion_config)
        sums = train_step(self.model, self.optimizer, model_batch, t, epsilon,
                          model_config=self.model_config, diffusion_config=self.diffusion_config,
                          tables=self.tables, bf16=self.bf16)
        self.global_step += 1
        self._nan |= torch.isnan(sums["total loss"])
        if metrics is not None:
            metrics.add_batch(sums, B)
        every = self.train_config.nan_check_every
        if every and self.global_step % every == 0 and bool(self._nan):
            raise RuntimeError("NaN loss")
        return sums

    def train_batches(self, batches, metrics=None) -> List[Dict[str, torch.Tensor]]:
        """K optimizer steps, one per batch in order: the same math as K
        ``train_batch`` calls."""
        return [self.train_batch(b, metrics) for b in batches]

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
