"""Pure noise and the reverse (denoising) step.

Counterpart of ``pmhc_tpu/diffusion/noise.py::gen_noise`` / ``add_noise``
/ ``remove_noise`` / ``remove_noise_scalars``, quat-native: rotation
composition is a Hamilton product. Randomness comes from an explicit
``torch.Generator`` on the output's device; it cannot reproduce
``jax.random`` draws, so tests inject the same numpy noise into both.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from pmhc_tpu_torch.diffusion.schedule import DiffusionConfig, ScheduleTables
from pmhc_tpu_torch.geometry import (
    RigidArray,
    inverse_sin_cos,
    multiply_sin_cos,
    partial_rot,
    partial_sin_cos,
    quat_invert,
    quat_multiply,
    shoemake_quat,
)

Noise = Dict[str, Any]  # {"frames": RigidArray, "torsions": [..., 7, 2]}


def gen_noise(generator: torch.Generator, shape, config: DiffusionConfig) -> Noise:
    """Pure noise of batch shape ``shape`` on the generator's device:
    translations ~ N(0, 5^2), rotations uniform on SO(3) (Shoemake),
    torsions uniform angles as (sin, cos)."""
    shape = tuple(shape)
    kw = {"generator": generator, "device": generator.device, "dtype": torch.float32}
    trans = torch.randn(shape + (3,), **kw) * config.position_noise_scale
    quats = shoemake_quat(torch.rand(shape + (3,), **kw))
    angles = torch.rand(shape + (7,), **kw) * (2.0 * math.pi)
    torsions = torch.stack((torch.sin(angles), torch.cos(angles)), dim=-1)
    return {"frames": RigidArray(quats, trans), "torsions": torsions}


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
