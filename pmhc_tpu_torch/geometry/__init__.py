"""Quaternion-native SE(3) geometry, the counterpart of ``pmhc_tpu.geometry``:
the same 22 public names (``random_quat`` / ``random_sin_cos`` take a
``torch.Generator`` where JAX takes a key), plus ``identity_quat``."""

from pmhc_tpu_torch.geometry.fape import compute_fape
from pmhc_tpu_torch.geometry.frame import get_rmsd
from pmhc_tpu_torch.geometry.quat import (
    get_quat_angle,
    identity_quat,
    partial_rot,
    quat_conjugate,
    quat_invert,
    quat_multiply,
    quat_multiply_by_vec,
    quat_rotate,
    quat_to_rot,
    random_quat,
    rot_to_quat,
    shoemake_quat,
    spherical_to_quat,
    torch_normalize,
)
from pmhc_tpu_torch.geometry.rigid import RigidArray
from pmhc_tpu_torch.geometry.sincos import (
    angle_to_sin_cos,
    get_sin_cos_angle,
    inverse_sin_cos,
    multiply_sin_cos,
    partial_sin_cos,
    random_sin_cos,
)

__all__ = [
    "quat_multiply",
    "quat_conjugate",
    "quat_invert",
    "quat_rotate",
    "quat_to_rot",
    "rot_to_quat",
    "shoemake_quat",
    "random_quat",
    "partial_rot",
    "get_quat_angle",
    "torch_normalize",
    "angle_to_sin_cos",
    "random_sin_cos",
    "multiply_sin_cos",
    "inverse_sin_cos",
    "partial_sin_cos",
    "get_sin_cos_angle",
    "spherical_to_quat",
    "quat_multiply_by_vec",
    "RigidArray",
    "get_rmsd",
    "compute_fape",
    "identity_quat",
]
