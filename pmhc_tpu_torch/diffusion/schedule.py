"""Noise schedule: linear beta with VDM-style direct interpolation.

Counterpart of ``pmhc_tpu/diffusion/schedule.py``: beta(t) = beta_min +
(beta_max - beta_min) * t/T, alpha = sqrt(1 - beta), sigma = sqrt(beta),
and the sampler's per-step alpha_ts / sigma_ts^2 / sigma_t2s chain, all
computed on the host in float64 and stored as float32. ``step_tables``
lays out a reverse chain's steps (the T-step chain or the strided grid)
as two arrays the sampler copies to the device once, where a step indexes
them with a step counter kept on the device; the trainer's draw indexes
the device copy of ``beta``/``alpha``/``sigma`` with a ``[B]`` tensor
(``beta_alpha_sigma``). So no step of either reads a host scalar, and a
CUDA graph can replay it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionConfig:
    """Engine hyperparameters; defaults are the reference's values."""

    noise_step_count: int = 1000  # T
    beta_min: float = 0.0
    beta_max: float = 0.8
    position_noise_scale: float = 5.0  # gen_noise translation stddev
    # total-loss weights (the reference hard-codes 0.1 / 1 / 1)
    position_loss_weight: float = 0.1
    rotation_loss_weight: float = 1.0
    torsion_loss_weight: float = 1.0
    # the reference's quirk: one random timestep per batch; False draws
    # one per sample
    t_per_batch: bool = True


def _beta(config: DiffusionConfig, frac: np.ndarray) -> np.ndarray:
    return config.beta_min + (config.beta_max - config.beta_min) * frac


class ScheduleTables:
    """float32 tables indexed by t in [0, T]; the sampler evaluates the
    model and the schedule at t = T (the reference's quirk), index 0 of the
    s = t-1 tables is padding."""

    def __init__(self, config: DiffusionConfig):
        T = config.noise_step_count
        beta = _beta(config, np.arange(T + 1, dtype=np.float64) / T)
        alpha = np.sqrt(1.0 - beta)
        sigma = np.sqrt(beta)
        alpha_ts = np.ones_like(alpha)
        alpha_ts[1:] = alpha[1:] / alpha[:-1]
        sqr_sigma_ts = np.zeros_like(sigma)
        sqr_sigma_ts[1:] = sigma[1:] ** 2 - sigma[:-1] ** 2 * alpha_ts[1:]
        sigma_ts = np.sqrt(np.maximum(sqr_sigma_ts, 0.0))
        sigma_t2s = np.zeros_like(sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma_t2s[1:] = sigma_ts[1:] * sigma[:-1] / np.where(sigma[1:] > 0, sigma[1:], 1.0)
        f32 = lambda x: x.astype(np.float32)
        self.beta, self.alpha, self.sigma = f32(beta), f32(alpha), f32(sigma)
        self.alpha_ts, self.sqr_sigma_ts = f32(alpha_ts), f32(sqr_sigma_ts)
        self.sigma_ts, self.sigma_t2s = f32(sigma_ts), f32(sigma_t2s)
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def beta_alpha_sigma(self, t):
        """(beta, alpha, sigma) at timestep ``t``: an int gives Python floats
        (the float32 values), an integer tensor gives float32 tensors of its
        shape, gathered on its device from a copy of the tables made there
        at the first call (outside any graph capture: the copy waits)."""
        if isinstance(t, torch.Tensor):
            table = self._on_device.get(t.device)
            if table is None:
                table = torch.from_numpy(np.stack((self.beta, self.alpha, self.sigma))).to(t.device)
                self._on_device[t.device] = table
            return tuple(table.index_select(1, t.long().reshape(-1)).reshape((3,) + t.shape))
        return float(self.beta[t]), float(self.alpha[t]), float(self.sigma[t])

    def scalars(self, t: int) -> Tuple[float, ...]:
        """The 6 reverse-step scalars of step t -> t-1, in
        ``remove_noise_scalars`` argument order."""
        return tuple(float(x) for x in (
            self.beta[t], self.sigma[t], self.beta[t - 1],
            self.alpha_ts[t], self.sqr_sigma_ts[t], self.sigma_t2s[t]))


def strided_timesteps(T: int, num_steps: int) -> np.ndarray:
    """Descending grid T = t_0 > t_1 > ... > t_K = 0, evenly spaced and
    deduplicated (K may come out slightly below ``num_steps``)."""
    if not 1 <= num_steps <= T:
        raise ValueError(f"num_steps must be in [1, {T}], got {num_steps}")
    ts = np.unique(np.round(np.linspace(0.0, T, num_steps + 1)).astype(np.int64))
    return ts[::-1].copy()


class StridedTables:
    """Per-jump reverse-step scalars for a descending t-grid (the few-step
    sampler): jump k evaluates the model at ``ts[k]`` and steps to
    ``ts[k+1]`` with alpha_ts = alpha_t/alpha_s, sigma_ts^2 = sigma_t^2 -
    sigma_s^2 * alpha_ts, sigma_t2s = sigma_ts * sigma_s / sigma_t."""

    def __init__(self, config: DiffusionConfig, ts: np.ndarray):
        ts = np.asarray(ts, np.int64)
        T = config.noise_step_count
        if ts[0] != T or ts[-1] != 0 or np.any(np.diff(ts) >= 0):
            raise ValueError(f"ts must descend from T={T} to 0, got {ts[:3]}..{ts[-3:]}")
        beta = _beta(config, ts.astype(np.float64) / T)
        alpha = np.sqrt(1.0 - beta)
        sigma = np.sqrt(beta)
        alpha_ts = alpha[:-1] / alpha[1:]
        sqr_sigma_ts = sigma[:-1] ** 2 - sigma[1:] ** 2 * alpha_ts
        sigma_ts = np.sqrt(np.maximum(sqr_sigma_ts, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma_t2s = sigma_ts * sigma[1:] / np.where(sigma[:-1] > 0, sigma[:-1], 1.0)
        f32 = lambda x: x.astype(np.float32)
        self.num_jumps = len(ts) - 1
        self.ts = ts[:-1].copy()
        self.beta_t, self.sigma_t, self.beta_s = f32(beta[:-1]), f32(sigma[:-1]), f32(beta[1:])
        self.alpha_ts, self.sqr_sigma_ts = f32(alpha_ts), f32(sqr_sigma_ts)
        self.sigma_t2s = f32(sigma_t2s)

    def scalars(self, k: int) -> Tuple[float, ...]:
        """The 6 reverse-step scalars of jump k."""
        return tuple(float(x) for x in (
            self.beta_t[k], self.sigma_t[k], self.beta_s[k],
            self.alpha_ts[k], self.sqr_sigma_ts[k], self.sigma_t2s[k]))


def step_tables(config: DiffusionConfig, num_steps: Optional[int] = None,
                tables: Optional[ScheduleTables] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A reverse chain's K steps, in order: the timestep each evaluates the
    model at (``[K]`` int64: T..1, or ``StridedTables.ts`` when
    ``num_steps`` is below T) and its six ``remove_noise_scalars`` scalars
    (``[K, 6]`` float32, rows equal to ``ScheduleTables.scalars(t)`` or
    ``StridedTables.scalars(k)``)."""
    T = config.noise_step_count
    if num_steps is not None and num_steps != T:
        st = StridedTables(config, strided_timesteps(T, num_steps))
        return st.ts.astype(np.int64), np.array([st.scalars(k) for k in range(st.num_jumps)],
                                                np.float32)
    tables = ScheduleTables(config) if tables is None else tables
    ts = np.arange(T, 0, -1, dtype=np.int64)
    return ts, np.array([tables.scalars(int(t)) for t in ts], np.float32)
