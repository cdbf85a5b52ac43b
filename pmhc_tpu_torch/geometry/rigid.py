"""RigidArray: quaternions + translations as a small tensor dataclass.

Counterpart of ``pmhc_tpu/geometry/rigid.py``. Construction does NOT
normalize quats (``from_tensor_7``), matching the reference's
``Rigid.from_tensor_7``; callers normalize explicitly where it does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pmhc_tpu_torch.geometry.quat import quat_to_rot


@dataclass
class RigidArray:
    quats: torch.Tensor  # f32[..., 4] scalar-first
    trans: torch.Tensor  # f32[..., 3]

    @classmethod
    def from_tensor_7(cls, t7: torch.Tensor) -> "RigidArray":
        """``[..., 7]`` = quat(4) || trans(3), no normalization."""
        return cls(t7[..., :4], t7[..., 4:])

    def to_tensor_7(self) -> torch.Tensor:
        return torch.cat((self.quats, self.trans), dim=-1)

    def rot_mats(self) -> torch.Tensor:
        return quat_to_rot(self.quats)

    @property
    def shape(self):
        return self.quats.shape[:-1]
