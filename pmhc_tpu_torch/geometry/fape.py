"""Frame-Aligned Point Error, the counterpart of ``pmhc_tpu/geometry/fape.py``
(AlphaFold 2, Alg. 28): target and predicted points in every frame's local
coordinates, the distance clamped (optionally) and scaled, a masked mean."""

from __future__ import annotations

from typing import Optional

import torch

from pmhc_tpu_torch.geometry.rigid import RigidArray


def compute_fape(
    pred_frames: RigidArray,  # [*, F]
    target_frames: RigidArray,  # [*, F]
    frames_mask: torch.Tensor,  # [*, F]
    pred_positions: torch.Tensor,  # [*, A, 3]
    target_positions: torch.Tensor,  # [*, A, 3]
    positions_mask: torch.Tensor,  # [*, A]
    length_scale: float = 10.0,
    l1_clamp_distance: Optional[float] = 10.0,
    eps: float = 1e-8,
) -> torch.Tensor:
    """FAPE per batch element."""
    def localize(frames: RigidArray, points: torch.Tensor) -> torch.Tensor:  # [*, F, A, 3]
        f = RigidArray(frames.quats[..., :, None, :], frames.trans[..., :, None, :])
        return f.invert_apply(points[..., None, :, :])

    local_pred = localize(pred_frames, pred_positions)
    local_target = localize(target_frames, target_positions)
    d = torch.sqrt(torch.sum(torch.square(local_pred - local_target), dim=-1) + eps)
    if l1_clamp_distance is not None:
        d = torch.clamp(d, 0.0, l1_clamp_distance)
    d = d / length_scale
    mask = frames_mask[..., :, None] * positions_mask[..., None, :]
    return torch.sum(d * mask, dim=(-2, -1)) / (torch.sum(mask, dim=(-2, -1)) + eps)
