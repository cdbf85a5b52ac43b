"""(sin, cos) pair algebra for torsion angles, ``[..., 2] = (sin a, cos a)``.

Counterpart of ``pmhc_tpu/geometry/sincos.py``: multiplication adds
angles and multiplies magnitudes; nothing is renormalized unless stated.
"""

from __future__ import annotations

import math

import torch

from pmhc_tpu_torch.geometry.quat import torch_normalize

PI = math.pi


def angle_to_sin_cos(angle: torch.Tensor) -> torch.Tensor:
    """``[...]`` angles -> ``[..., 2]`` (sin, cos)."""
    return torch.stack((torch.sin(angle), torch.cos(angle)), dim=-1)


def random_sin_cos(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform random angles in [0, 2pi) as (sin, cos), on the generator's device."""
    a = torch.rand(tuple(shape), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return angle_to_sin_cos(a * (2.0 * PI))


def multiply_sin_cos(sc1: torch.Tensor, sc2: torch.Tensor) -> torch.Tensor:
    """sin_out = s1*c2 + c1*s2 ; cos_out = c1*c2 - s1*s2 (not normalized)."""
    s1, c1 = sc1[..., :1], sc1[..., 1:]
    s2, c2 = sc2[..., :1], sc2[..., 1:]
    return torch.cat((s1 * c2 + c1 * s2, c1 * c2 - s1 * s2), dim=-1)


def inverse_sin_cos(sc: torch.Tensor) -> torch.Tensor:
    """Negate the angle, invert the magnitude (divides by the SQUARED norm)."""
    sqr_norm = torch.sum(sc * sc, dim=-1, keepdim=True)
    return torch.cat((-sc[..., :1], sc[..., 1:]), dim=-1) / sqr_norm


def partial_sin_cos(sc: torch.Tensor, amount) -> torch.Tensor:
    """Scale the angle by ``amount``; the output is a unit (sin, cos)."""
    sc = torch_normalize(sc)
    a = torch.arccos(torch.clamp(sc[..., 1:], -1.0, 1.0))
    a = torch.where(sc[..., :1] < 0.0, -a, a)
    return torch.cat((torch.sin(a * amount), torch.cos(a * amount)), dim=-1)


def get_sin_cos_angle(sc1: torch.Tensor, sc2: torch.Tensor) -> torch.Tensor:
    """The angle between two (sin, cos) vectors, in [0, pi]."""
    dot = torch.sum(torch_normalize(sc1) * torch_normalize(sc2), dim=-1)
    return torch.arccos(torch.clamp(dot, -1.0, 1.0))
