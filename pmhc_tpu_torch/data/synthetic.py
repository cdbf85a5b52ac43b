"""Synthetic pMHC data and the model-batch conversion.

Counterpart of ``pmhc_tpu/data/synthetic.py`` (``write_synthetic_hdf5``
and ``synthetic_batch``: the same seeded draws, so the same seed gives the
same file and the same arrays) and ``pmhc_tpu/train/trainer.py::prepare_batch``.
The schema is SwiftMHC's: per-complex groups with ``peptide``
(backbone_rigid_tensor, aatype, sequence_onehot, torsion_angles_sin_cos,
torsion_angles_mask) and ``protein`` (those plus atom14_gt_positions,
atom14_gt_exists, cross_residues_mask).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from pmhc_tpu_torch import constants as rc
from pmhc_tpu_torch.geometry import RigidArray

PEPTIDE_MAXLEN = 16
POCKET_MAXLEN = 80
ONEHOT_WIDTH = 22
MODEL_BATCH_KEYS = ("torsions", "features", "mask", "torsions_mask", "pocket_features",
                    "pocket_mask")


def rot_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Branchless Shepperd rotation -> unit quaternion, canonical w >= 0."""
    m = m.astype(np.float64)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = np.stack(
        (1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22),
        axis=-1,
    )
    qw = np.stack((1.0 + tr, m21 - m12, m02 - m20, m10 - m01), axis=-1)
    qx = np.stack((m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20), axis=-1)
    qy = np.stack((m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21), axis=-1)
    qz = np.stack((m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22), axis=-1)
    best = np.argmax(cands, axis=-1)[..., None]
    q = np.where(best == 0, qw, np.where(best == 1, qx, np.where(best == 2, qy, qz)))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.where(q[..., :1] < 0.0, -q, q)
    return q.astype(np.float32)


def frames_4x4_to_tensor7(frames: np.ndarray) -> np.ndarray:
    """[*, 4, 4] homogeneous -> [*, 7] quat || translation."""
    return np.concatenate(
        (rot_to_quat_np(frames[..., :3, :3]), frames[..., :3, 3].astype(np.float32)), axis=-1)


def _random_rotation(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform rotation matrices via normalized random quaternions."""
    q = rng.normal(size=tuple(shape) + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        (
            np.stack((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)), -1),
            np.stack((2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)), -1),
            np.stack((2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)), -1),
        ),
        axis=-2,
    )


def _random_frames_4x4(rng, n: int) -> np.ndarray:
    out = np.zeros((n, 4, 4), dtype=np.float32)
    out[:, :3, :3] = _random_rotation(rng, (n,))
    out[:, :3, 3] = rng.normal(size=(n, 3)) * 5.0
    out[:, 3, 3] = 1.0
    return out


def write_synthetic_hdf5(path: str, n_entries: int = 4, peptide_lengths: Sequence[int] = (9,),
                         protein_len: int = 120, pocket_len: int = 60, seed: int = 0) -> None:
    """Write a random SwiftMHC-format HDF5 file (needs h5py)."""
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f5:
        for i in range(n_entries):
            L = int(peptide_lengths[i % len(peptide_lengths)])
            g = f5.create_group(f"SYN{i:04d}")

            pep = g.create_group("peptide")
            pep["backbone_rigid_tensor"] = _random_frames_4x4(rng, L)
            aatype = rng.integers(0, 20, size=L)
            pep["aatype"] = aatype
            onehot = np.zeros((L, ONEHOT_WIDTH), dtype=np.float32)
            onehot[np.arange(L), aatype] = 1.0
            pep["sequence_onehot"] = onehot
            angles = rng.uniform(-np.pi, np.pi, size=(L, 7))
            pep["torsion_angles_sin_cos"] = np.stack(
                (np.sin(angles), np.cos(angles)), axis=-1).astype(np.float32)
            pep["torsion_angles_mask"] = (rng.uniform(size=(L, 7)) > 0.2).astype(np.float32)

            prot = g.create_group("protein")
            prot["backbone_rigid_tensor"] = _random_frames_4x4(rng, protein_len)
            p_aatype = rng.integers(0, 20, size=protein_len)
            prot["aatype"] = p_aatype
            p_onehot = np.zeros((protein_len, ONEHOT_WIDTH), dtype=np.float32)
            p_onehot[np.arange(protein_len), p_aatype] = 1.0
            prot["sequence_onehot"] = p_onehot
            prot["atom14_gt_positions"] = rng.normal(
                size=(protein_len, 14, 3)).astype(np.float32) * 3.0
            # masks are stored as bool (the reference reader indexes with
            # cross_residues_mask directly); exists is a subset of each
            # residue type's real atom14 slots, as in real data
            slot_ok = rc.restype_atom14_mask[p_aatype] > 0.5
            prot["atom14_gt_exists"] = (rng.uniform(size=(protein_len, 14)) > 0.3) & slot_ok
            cross = np.zeros(protein_len, dtype=bool)
            cross[rng.permutation(protein_len)[:pocket_len]] = True
            prot["cross_residues_mask"] = cross


def synthetic_batch(batch_size: int = 64, peptide_len: int = 9, pocket_len: int = 60,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """An in-memory numpy batch with the model's input contract (tensor-7
    frames, masks, one-hots)."""
    rng = np.random.default_rng(seed)
    B, N, P = batch_size, PEPTIDE_MAXLEN, POCKET_MAXLEN

    def frames_t7(n_valid, maxlen):
        f = np.broadcast_to(np.eye(4, dtype=np.float32), (B, maxlen, 4, 4)).copy()
        for b in range(B):
            f[b, :n_valid] = _random_frames_4x4(rng, n_valid)
        return frames_4x4_to_tensor7(f)

    mask = np.zeros((B, N), dtype=bool)
    mask[:, :peptide_len] = True
    pocket_mask = np.zeros((B, P), dtype=bool)
    pocket_mask[:, :pocket_len] = True

    features = np.zeros((B, N, ONEHOT_WIDTH), dtype=np.float32)
    aatype = rng.integers(0, 20, size=(B, N)).astype(np.int32)
    features[np.arange(B)[:, None], np.arange(N)[None, :], aatype] = 1.0
    features[~mask] = 0.0
    pocket_features = np.zeros((B, P, ONEHOT_WIDTH), dtype=np.float32)
    p_aatype = rng.integers(0, 20, size=(B, P)).astype(np.int32)
    pocket_features[np.arange(B)[:, None], np.arange(P)[None, :], p_aatype] = 1.0
    pocket_features[~pocket_mask] = 0.0

    angles = rng.uniform(-np.pi, np.pi, size=(B, N, 7))
    torsions = np.stack((np.sin(angles), np.cos(angles)), axis=-1).astype(np.float32)
    torsions_mask = np.zeros((B, N, 7), dtype=bool)
    torsions_mask[:, :peptide_len, 3:] = True
    torsions_mask[:, peptide_len - 1, 2] = True
    torsions[~torsions_mask] = np.array([0.0, 1.0], dtype=np.float32)

    return {
        "mask": mask,
        "frames": frames_t7(peptide_len, N),
        "features": features,
        "aatype": aatype,
        "torsions": torsions,
        "torsions_mask": torsions_mask,
        "pocket_aatype": p_aatype,
        "pocket_features": pocket_features,
        "pocket_mask": pocket_mask,
        "pocket_frames": frames_t7(pocket_len, P),
    }


def _to_device(x, device, float32: bool = False) -> torch.Tensor:
    """A tensor passes to ``device`` with ``.to`` (untouched when it is
    there already); anything else goes through numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32 if float32 else None)
    return torch.as_tensor(np.asarray(x, np.float32 if float32 else None), device=device)


def prepare_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Loader batch (numpy or tensors, tensor-7 frames) -> model input on
    ``device`` (RigidArray frames, no quat normalization, like
    ``Rigid.from_tensor_7``)."""
    out = {k: _to_device(batch[k], device) for k in MODEL_BATCH_KEYS if k in batch}
    for k in ("frames", "pocket_frames"):
        out[k] = RigidArray.from_tensor_7(_to_device(batch[k], device, float32=True))
    return out

