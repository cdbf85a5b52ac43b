"""Composite diffusion loss.

Counterpart of ``pmhc_tpu/diffusion/loss.py::diffusion_loss``:

- positions: masked mean over residues of the squared deviation (not
  RMSD), weighted 0.1 in the total;
- rotations: 1 - <normalize(q_true), normalize(q_pred)>, masked mean
  (sign-sensitive by design);
- torsions: 1 - <normalize(sc_true), normalize(sc_pred)>, masked mean over
  (residues, 7 angles);
- ``rmsd`` is reported, not optimized.

Returns per-sample ``[B]`` vectors under the JAX package's five names; the
trainer reduces them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from pmhc_tpu_torch.geometry import torch_normalize

# the keys of ``diffusion_loss``'s result, in its order
LOSS_NAMES = ("total loss", "positions loss", "rotations loss", "torsions loss", "rmsd")


def diffusion_loss(noise_true: Dict[str, Any], noise_pred: Dict[str, Any],
                   residues_mask: torch.Tensor, torsions_mask: torch.Tensor,
                   position_loss_weight: float = 0.1, rotation_loss_weight: float = 1.0,
                   torsion_loss_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    mask = residues_mask.float()
    tmask = torsions_mask.float()
    true_f, pred_f = noise_true["frames"], noise_pred["frames"]

    sq_dev = torch.sum((true_f.trans - pred_f.trans) ** 2, dim=-1)
    positions = torch.sum(sq_dev * mask, dim=-1) / torch.sum(mask, dim=-1)
    quat_dev = 1.0 - torch.sum(torch_normalize(true_f.quats) * torch_normalize(pred_f.quats), dim=-1)
    rotations = torch.sum(quat_dev * mask, dim=-1) / torch.sum(mask, dim=-1)
    tors_dev = 1.0 - torch.sum(torch_normalize(noise_true["torsions"])
                               * torch_normalize(noise_pred["torsions"]), dim=-1)
    torsions = torch.sum(tors_dev * tmask, dim=(-2, -1)) / torch.sum(tmask, dim=(-2, -1))
    return {
        "total loss": position_loss_weight * positions + rotation_loss_weight * rotations
        + torsion_loss_weight * torsions,
        "positions loss": positions,
        "rotations loss": rotations,
        "torsions loss": torsions,
        "rmsd": torch.sqrt(positions),
    }
