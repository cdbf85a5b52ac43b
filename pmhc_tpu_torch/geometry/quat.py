"""Quaternion algebra on ``[..., 4]`` tensors (scalar-first, Hamilton).

Counterpart of ``pmhc_tpu/geometry/quat.py``: the same conventions and
reference quirks — ``torch_normalize`` divides by ``max(||x||, eps)``,
``quat_invert`` divides by the squared norm, ``partial_rot`` does not
renormalize its output, ``rot_to_quat`` is the branchless Shepperd form
with the sign fixed to w >= 0 (as ``data/synthetic.py::rot_to_quat_np``).
Everything is float32. ``random_quat`` draws from a ``torch.Generator``
where the JAX function takes a key.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def torch_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize; a zero vector maps to zeros, not NaN."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def identity_quat(like: torch.Tensor) -> torch.Tensor:
    """[1, 0, 0, 0] in ``like``'s dtype, built on its device (no copy from
    the host, so a CUDA graph can capture it)."""
    return torch.eye(1, 4, dtype=like.dtype, device=like.device)[0]


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


def quat_multiply_by_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multiply quaternions ``[..., 4]`` by pure-vector quaternions ``[..., 3]``."""
    w1, x1, y1, z1 = q.unbind(-1)
    x2, y2, z2 = v.unbind(-1)
    return torch.stack(
        (
            -x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2,
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


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``[..., 3]`` by quaternions ``[..., 4]`` (as R(q) @ v),
    an elementwise contraction kept in fp32 whatever matmul precision is set."""
    return torch.sum(quat_to_rot(q) * v[..., None, :], dim=-1)


def rot_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]``: all four
    Shepperd candidates, the best-conditioned one picked with ``where`` (no
    branch, no eigh), the sign canonicalized to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack((1.0 + tr, m21 - m12, m02 - m20, m10 - m01), dim=-1)
    qx = torch.stack((m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20), dim=-1)
    qy = torch.stack((m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21), dim=-1)
    qz = torch.stack((m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22), dim=-1)
    cands = torch.stack((1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                         1.0 - m00 - m11 + m22), dim=-1)
    best = torch.argmax(cands, dim=-1)[..., None]  # the first of equal maxima, as jnp.argmax
    q = torch.where(best == 0, qw, torch.where(best == 1, qx, torch.where(best == 2, qy, qz)))
    q = torch_normalize(q)
    return torch.where(q[..., :1] < 0.0, -q, q)


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


def random_quat(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform random unit quaternions of batch shape ``shape`` on the
    generator's device: Shoemake of three uniforms."""
    x = torch.rand(tuple(shape) + (3,), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return shoemake_quat(x)


def spherical_to_quat(axis_phi: torch.Tensor, axis_theta: torch.Tensor,
                      alpha: torch.Tensor) -> torch.Tensor:
    """Axis in spherical coordinates and a rotation angle -> unit quaternion."""
    xy = torch.stack((torch.cos(axis_phi), torch.sin(axis_phi)), dim=-1)
    xyz = torch.cat((xy * torch.sin(axis_theta)[..., None], torch.cos(axis_theta)[..., None]), dim=-1)
    a2 = alpha / 2.0
    return torch.cat((torch.cos(a2)[..., None], xyz * torch.sin(a2)[..., None]), dim=-1)


def get_quat_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The angle between two quaternions: arccos |<q1, q2>| of the normalized pair."""
    dot = torch.clamp(torch.sum(torch_normalize(q1) * torch_normalize(q2), dim=-1), -1.0, 1.0)
    return torch.arccos(torch.abs(dot))


def partial_rot(q: torch.Tensor, amount) -> torch.Tensor:
    """Scale the rotation angle of ``q`` by ``amount``: normalize q, half
    angle a2 = acos(clamp(w)), axis normalized with torch semantics (the
    identity quat has a zero axis). The output is NOT re-normalized."""
    q = torch_normalize(q)
    a2 = torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    axis = torch_normalize(q[..., 1:])
    return torch.cat((torch.cos(a2 * amount), torch.sin(a2 * amount) * axis), dim=-1)
