"""Quaternion algebra on ``[..., 4]`` tensors (scalar-first, Hamilton).

Counterpart of ``pmhc_tpu/geometry/quat.py``: the same conventions and
reference quirks — ``torch_normalize`` divides by ``max(||x||, eps)``,
``quat_invert`` divides by the squared norm, ``partial_rot`` does not
renormalize its output. Everything is float32.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def torch_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize; a zero vector maps to zeros, not NaN."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``[..., 4] x [..., 4] -> [..., 4]`` (broadcasting)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        (
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ),
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat((q[..., :1], -q[..., 1:]), dim=-1)


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse = conjugate / squared norm."""
    return quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[..., 4]`` -> rotation matrix ``[..., 3, 3]``; quadratic
    in q without normalization (a non-unit q scales the matrix by |q|^2)."""
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack((ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)), dim=-1)
    row1 = torch.stack((2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)), dim=-1)
    row2 = torch.stack((2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz), dim=-1)
    return torch.stack((row0, row1, row2), dim=-2)


def shoemake_quat(x: torch.Tensor) -> torch.Tensor:
    """Shoemake coordinates ``[..., 3]`` in [0, 1] -> uniform unit quaternion."""
    x = torch.clamp(x, 0.0, 1.0)
    theta1 = 2.0 * PI * x[..., 1:2]
    theta2 = 2.0 * PI * x[..., 2:3]
    r1 = torch.sqrt(1.0 - x[..., 0:1])
    r2 = torch.sqrt(x[..., 0:1])
    return torch.cat(
        (
            r2 * torch.cos(theta2),
            r1 * torch.sin(theta1),
            r1 * torch.cos(theta1),
            r2 * torch.sin(theta2),
        ),
        dim=-1,
    )


def partial_rot(q: torch.Tensor, amount) -> torch.Tensor:
    """Scale the rotation angle of ``q`` by ``amount``: normalize q, half
    angle a2 = acos(clamp(w)), axis normalized with torch semantics (the
    identity quat has a zero axis). The output is NOT re-normalized."""
    q = torch_normalize(q)
    a2 = torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    axis = torch_normalize(q[..., 1:])
    return torch.cat((torch.cos(a2 * amount), torch.sin(a2 * amount) * axis), dim=-1)
