"""Pure noise and the reverse (denoising) step.

Counterpart of ``pmhc_tpu/diffusion/noise.py::gen_noise`` / ``add_noise``
/ ``remove_noise`` / ``remove_noise_scalars``, quat-native: rotation
composition is a Hamilton product. Randomness comes from an explicit
``torch.Generator`` on the output's device; it cannot reproduce
``jax.random`` draws, so tests inject the same numpy noise into both.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from pmhc_tpu_torch.diffusion.schedule import DiffusionConfig, ScheduleTables
from pmhc_tpu_torch.geometry import (
    RigidArray,
    angle_to_sin_cos,
    inverse_sin_cos,
    multiply_sin_cos,
    partial_rot,
    partial_sin_cos,
    quat_invert,
    quat_multiply,
    shoemake_quat,
)

Noise = Dict[str, Any]  # {"frames": RigidArray, "torsions": [..., 7, 2]}
PI = math.pi


class Draws(NamedTuple):
    """One step's raw draws, in ``gen_noise``'s order and shapes, and the
    translations' scale (``position_noise_scale``) that turns them into
    ``Noise`` (``noise_of``)."""

    normal: torch.Tensor    # [..., 3] standard normal: translations
    shoemake: torch.Tensor  # [..., 3] uniform: Shoemake coordinates of the rotation
    angles: torch.Tensor    # [..., 7] uniform: torsion angles over 2 pi
    scale: float


def draw_noise(generator: torch.Generator, shape, config: DiffusionConfig,
               out: Optional[Draws] = None) -> Draws:
    """The raw draws of ``gen_noise`` for batch shape ``shape``, from the
    generator on its device: ``randn`` [..., 3], ``rand`` [..., 3], ``rand``
    [..., 7], in that order; into ``out``'s tensors when given."""
    shape = tuple(shape)

    def one(fn, i, n):
        if out is None:
            return fn(shape + (n,), generator=generator, device=generator.device,
                      dtype=torch.float32)
        return fn(shape + (n,), generator=generator, out=out[i])

    return Draws(one(torch.randn, 0, 3), one(torch.rand, 1, 3), one(torch.rand, 2, 7),
                 config.position_noise_scale)


def noise_of(draws: Draws) -> Noise:
    """The noise of ``draws``: translations ~ N(0, scale^2), rotations
    uniform on SO(3) (Shoemake), torsions uniform angles as (sin, cos)."""
    return {"frames": RigidArray(shoemake_quat(draws.shoemake), draws.normal * draws.scale),
            "torsions": angle_to_sin_cos(draws.angles * (2.0 * PI))}


def gen_noise(generator: torch.Generator, shape, config: DiffusionConfig) -> Noise:
    """Pure noise of batch shape ``shape`` on the generator's device
    (``noise_of`` of ``draw_noise``)."""
    return noise_of(draw_noise(generator, shape, config))


def add_noise(signal: Dict[str, Any], noise: Noise, t, tables: ScheduleTables) -> Dict[str, Any]:
    """Forward process x0 -> z_t in one jump: torsions get a beta-fraction
    of the noise angle multiplied on, positions interpolate signal * alpha
    + noise * sigma, rotations get a beta-fraction of the noise rotation
    composed on the left. ``t`` is an int (one t per batch) or a ``[B]``
    integer tensor, broadcast on the leading axis."""
    beta, alpha, sigma = tables.beta_alpha_sigma(t)

    def bcast(x, ndim):  # [B] -> [B, 1, ..., 1]; a float stays a float
        return x.reshape(x.shape + (1,) * (ndim - 1)) if isinstance(x, torch.Tensor) else x

    sf: RigidArray = signal["frames"]
    nf: RigidArray = noise["frames"]
    result = dict(signal)
    result["torsions"] = multiply_sin_cos(
        partial_sin_cos(noise["torsions"], bcast(beta, 4)), signal["torsions"])
    result["frames"] = RigidArray(
        quat_multiply(partial_rot(nf.quats, bcast(beta, 3)), sf.quats),
        sf.trans * bcast(alpha, 3) + nf.trans * bcast(sigma, 3))
    return result


def remove_noise(noised: Dict[str, Any], predicted: Noise, random_noise: Noise, t: int,
                 tables: ScheduleTables) -> Dict[str, Any]:
    """One reverse step z_t -> z_{t-1} with fresh stochastic noise."""
    return remove_noise_scalars(noised, predicted, random_noise, *tables.scalars(t))


def remove_noise_scalars(noised: Dict[str, Any], predicted: Noise, random_noise: Noise,
                         beta_t, sigma_t, beta_s, alpha_ts, sqr_sigma_ts, sigma_t2s
                         ) -> Dict[str, Any]:
    """``remove_noise`` with the six per-jump scalars passed explicitly
    (the general (t, s) form used by the strided sampler)."""
    nf: RigidArray = noised["frames"]
    pf: RigidArray = predicted["frames"]
    rf: RigidArray = random_noise["frames"]

    # positions: posterior mean + stochastic term
    pos = nf.trans / alpha_ts - (pf.trans * sqr_sigma_ts) / (alpha_ts * sigma_t) \
        + sigma_t2s * rf.trans
    # rotations: invert the predicted partial rotation, re-add a partial
    # random rotation at level s (quat_invert, not conjugate: partial_rot
    # may emit a non-unit quat)
    rot = quat_multiply(
        partial_rot(rf.quats, beta_s),
        quat_multiply(quat_invert(partial_rot(pf.quats, beta_t)), nf.quats),
    )
    # torsions: the same inversion pattern in sin/cos space
    torsions = multiply_sin_cos(
        partial_sin_cos(random_noise["torsions"], beta_s),
        multiply_sin_cos(
            inverse_sin_cos(partial_sin_cos(predicted["torsions"], beta_t)),
            noised["torsions"],
        ),
    )
    result = dict(noised)
    result["frames"] = RigidArray(rot, pos)
    result["torsions"] = torsions
    return result
