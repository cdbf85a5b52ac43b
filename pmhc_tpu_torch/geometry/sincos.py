"""(sin, cos) pair algebra for torsion angles, ``[..., 2] = (sin a, cos a)``.

Counterpart of ``pmhc_tpu/geometry/sincos.py``: multiplication adds
angles and multiplies magnitudes; nothing is renormalized unless stated.
"""

from __future__ import annotations

import torch

from pmhc_tpu_torch.geometry.quat import torch_normalize


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
