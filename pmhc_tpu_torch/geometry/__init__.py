from pmhc_tpu_torch.geometry.quat import (
    partial_rot,
    quat_conjugate,
    quat_invert,
    quat_multiply,
    quat_to_rot,
    shoemake_quat,
    torch_normalize,
)
from pmhc_tpu_torch.geometry.rigid import RigidArray
from pmhc_tpu_torch.geometry.sincos import (
    inverse_sin_cos,
    multiply_sin_cos,
    partial_sin_cos,
)

__all__ = [
    "RigidArray",
    "inverse_sin_cos",
    "multiply_sin_cos",
    "partial_rot",
    "partial_sin_cos",
    "quat_conjugate",
    "quat_invert",
    "quat_multiply",
    "quat_to_rot",
    "shoemake_quat",
    "torch_normalize",
]
