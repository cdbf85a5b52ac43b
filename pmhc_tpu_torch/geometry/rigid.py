"""RigidArray: quaternions + translations as a small tensor dataclass.

Counterpart of ``pmhc_tpu/geometry/rigid.py``, every method of the JAX
class but its pytree protocol. Construction does NOT normalize quats
(``from_tensor_7``), matching the reference's ``Rigid.from_tensor_7``;
callers normalize explicitly where it does. ``invert`` and
``invert_apply`` normalize the quaternion they invert, as the JAX class
does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pmhc_tpu_torch.geometry.quat import (
    quat_conjugate,
    quat_multiply,
    quat_rotate,
    quat_to_rot,
    rot_to_quat,
    torch_normalize,
)


@dataclass
class RigidArray:
    quats: torch.Tensor  # f32[..., 4] scalar-first
    trans: torch.Tensor  # f32[..., 3]

    # -- constructors ------------------------------------------------------
    @classmethod
    def identity(cls, shape, dtype=torch.float32, device=None) -> "RigidArray":
        """Identity transforms of batch shape ``shape``."""
        q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return cls(q, torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))

    @classmethod
    def from_tensor_7(cls, t7: torch.Tensor) -> "RigidArray":
        """``[..., 7]`` = quat(4) || trans(3), no normalization."""
        return cls(t7[..., :4], t7[..., 4:])

    @classmethod
    def from_tensor_4x4(cls, t44: torch.Tensor) -> "RigidArray":
        """``[..., 4, 4]`` homogeneous transform (``rot_to_quat``: w >= 0)."""
        return cls(rot_to_quat(t44[..., :3, :3]), t44[..., :3, 3])

    # -- conversions -------------------------------------------------------
    def to_tensor_7(self) -> torch.Tensor:
        return torch.cat((self.quats, self.trans), dim=-1)

    def to_tensor_4x4(self) -> torch.Tensor:
        out = torch.zeros(self.trans.shape[:-1] + (4, 4), dtype=self.trans.dtype,
                          device=self.trans.device)
        out[..., :3, :3] = quat_to_rot(self.quats)
        out[..., :3, 3] = self.trans
        out[..., 3, 3] = 1.0
        return out

    def rot_mats(self) -> torch.Tensor:
        return quat_to_rot(self.quats)

    # -- algebra -----------------------------------------------------------
    def compose(self, other: "RigidArray") -> "RigidArray":
        """self o other (``other`` applied first, in the frame of ``self``)."""
        return RigidArray(quat_multiply(self.quats, other.quats),
                          quat_rotate(self.quats, other.trans) + self.trans)

    def compose_rotation(self, q: torch.Tensor) -> "RigidArray":
        """Left-compose a rotation onto self's rotation, translation unchanged."""
        return RigidArray(quat_multiply(q, self.quats), self.trans)

    def invert(self) -> "RigidArray":
        inv_q = quat_conjugate(torch_normalize(self.quats))
        return RigidArray(inv_q, -quat_rotate(inv_q, self.trans))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """R @ p + t on points ``[..., 3]``."""
        return quat_rotate(self.quats, points) + self.trans

    def invert_apply(self, points: torch.Tensor) -> torch.Tensor:
        inv_q = quat_conjugate(torch_normalize(self.quats))
        return quat_rotate(inv_q, points - self.trans)

    def normalize(self) -> "RigidArray":
        """A copy with unit quaternions (torch normalize semantics)."""
        return RigidArray(torch_normalize(self.quats), self.trans)

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        return self.quats.shape[:-1]

    @property
    def dtype(self):
        return self.quats.dtype

    def __getitem__(self, idx) -> "RigidArray":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return RigidArray(self.quats[idx], self.trans[idx])

    def reshape(self, shape) -> "RigidArray":
        shape = tuple(shape)
        return RigidArray(self.quats.reshape(shape + (4,)), self.trans.reshape(shape + (3,)))

    @staticmethod
    def cat(rigids, dim: int = 0) -> "RigidArray":
        if dim < 0:
            dim -= 1  # past the trailing component axis
        return RigidArray(torch.cat([r.quats for r in rigids], dim=dim),
                          torch.cat([r.trans for r in rigids], dim=dim))
