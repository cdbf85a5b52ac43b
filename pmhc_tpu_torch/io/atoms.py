"""Torsion frames and idealized atom placement.

Counterpart of ``pmhc_tpu/io/atoms.py`` (OpenFold's
``torsion_angles_to_frames`` and ``frames_and_literature_positions_to_atom14_pos``).
Computed in matrix space from the raw (possibly unnormalized) sin/cos,
like the reference. The 3x3 products are written as elementwise
contractions, so they stay full fp32 whatever TF32 setting is active.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pmhc_tpu_torch.geometry import RigidArray, quat_to_rot

BACKBONE_GROUP = 0
PSI_GROUP = 3  # the backbone O hangs off the psi group


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as an elementwise contraction."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] as an elementwise contraction."""
    return torch.sum(m * v[..., None, :], dim=-1)


def torsion_angles_to_frames(
    frames: RigidArray,            # [*, N] backbone frames
    torsions: torch.Tensor,        # [*, N, 7, 2] (sin, cos)
    aatype: torch.Tensor,          # [*, N] int
    default_frames: torch.Tensor,  # [21, 8, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rot_mats [*, N, 8, 3, 3], trans [*, N, 8, 3]): the 8 rigid-group
    frames of every residue in global coordinates."""
    default_4x4 = default_frames[aatype.long()]
    d_rot = default_4x4[..., :3, :3]
    d_trans = default_4x4[..., :3, 3]

    # the backbone group's (sin, cos) = (0, 1), built on the device
    bb = torch.eye(2, dtype=torsions.dtype, device=torsions.device)[1]
    bb = torch.broadcast_to(bb, torsions.shape[:-2] + (1, 2))
    alpha = torch.cat((bb, torsions), dim=-2)  # [*, N, 8, 2]
    sin_a, cos_a = alpha[..., 0], alpha[..., 1]
    zeros, ones = torch.zeros_like(sin_a), torch.ones_like(sin_a)
    x_rot = torch.stack(
        (
            torch.stack((ones, zeros, zeros), dim=-1),
            torch.stack((zeros, cos_a, -sin_a), dim=-1),
            torch.stack((zeros, sin_a, cos_a), dim=-1),
        ),
        dim=-2,
    )
    g_rot = _mm(d_rot, x_rot)
    rots = [g_rot[..., i, :, :] for i in range(8)]
    trs = [d_trans[..., i, :] for i in range(8)]
    for chi in (5, 6, 7):  # chi2..chi4 chained onto the previous chi
        rots[chi], trs[chi] = _mm(rots[chi - 1], rots[chi]), _mv(rots[chi - 1], trs[chi]) + trs[chi - 1]
    g_rot = torch.stack(rots, dim=-3)
    g_trans = torch.stack(trs, dim=-2)

    bb_rot = quat_to_rot(frames.quats)[..., None, :, :]
    out_rot = _mm(bb_rot, g_rot)
    out_trans = _mv(bb_rot, g_trans) + frames.trans[..., None, :]
    return out_rot, out_trans


def frames_to_atom14_positions(
    group_rots: torch.Tensor,     # [*, N, 8, 3, 3]
    group_trans: torch.Tensor,    # [*, N, 8, 3]
    aatype: torch.Tensor,         # [*, N]
    group_idx: torch.Tensor,      # [21, 14]
    atom_mask: torch.Tensor,      # [21, 14]
    lit_positions: torch.Tensor,  # [21, 14, 3]
) -> torch.Tensor:
    """[*, N, 14, 3] idealized atom positions."""
    aatype = aatype.long()
    groups = group_idx[aatype].long()  # [*, N, 14]
    flat = group_rots.reshape(group_rots.shape[:-2] + (9,))
    rots = torch.gather(flat, -2, groups[..., None].expand(groups.shape + (9,)))
    rots = rots.reshape(rots.shape[:-1] + (3, 3))
    trans = torch.gather(group_trans, -2, groups[..., None].expand(groups.shape + (3,)))
    pred = _mv(rots, lit_positions[aatype]) + trans
    return pred * atom_mask[aatype][..., None]
