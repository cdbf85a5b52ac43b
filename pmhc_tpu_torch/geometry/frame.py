"""Frame-set RMSD, the counterpart of ``pmhc_tpu/geometry/frame.py``: the
RMSD between two frame sets' translations, unmasked, averaged over the
residue axis."""

from __future__ import annotations

import torch

from pmhc_tpu_torch.geometry.rigid import RigidArray


def get_rmsd(pred_frames: RigidArray, true_frames: RigidArray) -> torch.Tensor:
    """sqrt(sum((t_true - t_pred)^2) / N) per batch element."""
    sq = torch.sum(torch.square(true_frames.trans - pred_frames.trans), dim=(-2, -1))
    return torch.sqrt(sq / pred_frames.shape[-1])
