"""Physically coherent synthetic pMHC complexes.

Counterpart of ``pmhc_tpu/data/realistic.py``: the same seeded draws in
the same order, so a seed gives the same entries. Unlike
``write_synthetic_hdf5``'s i.i.d. content, these complexes differ from
each other as real SwiftMHC exports do:

- ragged pockets: ``cross_residues_mask`` marks the MHC residues whose CA
  lies near the peptide, so the count varies per entry;
- variable MHC length; mixed 8-11-mer peptides;
- coherent backbones: an extended peptide strand in a groove between two
  MHC helices above a sheet floor, frames from a Gram-Schmidt triad along
  the CA trace;
- per-residue-type torsion masks and atom14 existence masks that are
  subsets of each type's real atom14 slots.

``realistic_entries`` yields the raw entries (the HDF5 groups as dicts of
numpy arrays) and needs no h5py; ``write_realistic_hdf5`` writes them and
``realistic_packed`` packs them (the input of a machine without HDF5).
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from pmhc_tpu_torch import constants as rc
from pmhc_tpu_torch.data.dataset import pad_entry, protein_arrays
from pmhc_tpu_torch.data.packed import PackedDataset
from pmhc_tpu_torch.data.synthetic import ONEHOT_WIDTH

# rough human proteome frequencies for the 20 restypes (ARNDCQEGHILKMFPSTWYV)
_AA_FREQ = np.array([
    8.3, 5.5, 4.0, 5.4, 1.4, 3.9, 6.8, 7.1, 2.3, 5.9,
    9.7, 5.8, 2.4, 3.9, 4.7, 6.6, 5.3, 1.1, 2.9, 6.9,
])
_AA_FREQ = _AA_FREQ / _AA_FREQ.sum()

RawEntry = Dict[str, Dict[str, np.ndarray]]


def _frames_from_ca_trace(ca: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Backbone rigid frames [L, 4, 4] from a CA trace: x along the chain,
    z a smoothed normal."""
    L = ca.shape[0]
    fwd = np.zeros((L, 3))
    fwd[:-1] = ca[1:] - ca[:-1]
    fwd[-1] = fwd[-2] if L > 1 else np.array([1.0, 0.0, 0.0])
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True) + 1e-9

    up = np.cross(fwd, np.roll(fwd, 1, axis=0)) + rng.normal(size=(L, 3)) * 0.05
    up -= fwd * np.sum(up * fwd, axis=-1, keepdims=True)
    norms = np.linalg.norm(up, axis=-1, keepdims=True)
    up = np.where(norms > 1e-6, up / (norms + 1e-9), np.array([0.0, 0.0, 1.0]))
    side = np.cross(up, fwd)

    out = np.zeros((L, 4, 4), dtype=np.float32)
    out[:, :3, 0] = fwd
    out[:, :3, 1] = side
    out[:, :3, 2] = up
    out[:, :3, 3] = ca
    out[:, 3, 3] = 1.0
    return out


def _helix_ca(n: int, start: np.ndarray, direction: np.ndarray,
              rng: np.random.Generator) -> np.ndarray:
    """CA trace of an ideal alpha helix (rise 1.5 A, 100 deg/res, radius
    2.3 A) along ``direction``."""
    direction = direction / np.linalg.norm(direction)
    ref = np.array([0.0, 0.0, 1.0])
    if abs(direction @ ref) > 0.9:
        ref = np.array([1.0, 0.0, 0.0])
    u = np.cross(direction, ref)
    u /= np.linalg.norm(u)
    v = np.cross(direction, u)
    t = np.arange(n)
    ang = np.deg2rad(100.0) * t
    ca = (start[None]
          + direction[None] * (1.5 * t)[:, None]
          + u[None] * (2.3 * np.cos(ang))[:, None]
          + v[None] * (2.3 * np.sin(ang))[:, None])
    return ca + rng.normal(size=ca.shape) * 0.08


def _strand_ca(n: int, start: np.ndarray, direction: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
    """Extended-strand CA trace: 3.8 A steps with a 1 A zigzag."""
    direction = direction / np.linalg.norm(direction)
    zig = np.array([0.0, 0.0, 1.0])
    t = np.arange(n)
    ca = (start[None] + direction[None] * (3.8 * t)[:, None]
          + zig[None] * (0.5 * (-1.0) ** t)[:, None])
    return ca + rng.normal(size=ca.shape) * 0.06


def _chi_mask_table() -> np.ndarray:
    """[21, 7] torsion existence per restype: pre-omega/phi/psi always,
    chi_g iff any atom14 slot maps to rigid group 4+g."""
    groups = rc.restype_atom14_to_rigid_group
    mask14 = rc.restype_atom14_mask
    out = np.zeros((groups.shape[0], 7), dtype=np.float32)
    out[:, :3] = 1.0
    for g in range(4):
        out[:, 3 + g] = (((groups == 4 + g) & (mask14 > 0.5)).any(axis=1).astype(np.float32))
    return out


def _atom14_from_frames(frames: np.ndarray, aatype: np.ndarray, rng: np.random.Generator):
    """Backbone-group atom14 coordinates from each residue frame applied to
    the literature positions; side-chain slots near CB with noise. exists =
    the residue type's real atom14 slots, a few % dropped."""
    L = aatype.shape[0]
    pos = np.zeros((L, 14, 3), dtype=np.float32)
    mask14 = rc.restype_atom14_mask[aatype] > 0.5
    rot = frames[:, :3, :3]
    tr = frames[:, :3, 3]
    for i in range(L):
        aa = rc.restype_1to3[rc.restypes[int(aatype[i])]]
        names = rc.restype_name_to_atom14_names[aa]
        lit = {a: p for a, g, p in rc.rigid_group_atom_positions[aa] if g == 0}
        anchor = tr[i]
        for s, name in enumerate(names):
            if not name:
                continue
            if name in lit:
                pos[i, s] = rot[i] @ np.asarray(lit[name]) + tr[i]
                if name == "CB" or (name == "CA" and "CB" not in lit):
                    anchor = pos[i, s]
            else:
                pos[i, s] = anchor + rng.normal(size=3) * 0.9 + np.array([0.0, 0.0, 1.2])
    exists = mask14 & (rng.uniform(size=(L, 14)) > 0.03)
    exists[:, :4] = mask14[:, :4]  # backbone always resolved
    return pos, exists


def realistic_entries(
    n_entries: int = 8,
    peptide_lengths: Sequence[int] = (8, 9, 10, 11),
    protein_len_range=(150, 180),
    pocket_radius: float = 12.0,
    seed: int = 0,
) -> Iterator[Tuple[str, RawEntry]]:
    """Yield ``(name, {"peptide": {...}, "protein": {...}})`` raw entries in
    the SwiftMHC schema, named ``REAL0000``, ``REAL0001``, ..."""
    rng = np.random.default_rng(seed)
    chi_table = _chi_mask_table()
    for i in range(n_entries):
        L = int(peptide_lengths[i % len(peptide_lengths)])
        plen = int(rng.integers(*protein_len_range))

        # peptide strand in the groove (along x, at z ~ 0)
        pep_ca = _strand_ca(L, np.array([-1.9 * L, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]), rng)
        pep_frames = _frames_from_ca_trace(pep_ca, rng)

        # MHC: two helices flanking the groove + a floor sheet below
        n_h = (plen - 40) // 2
        h1 = _helix_ca(n_h, np.array([-30.0, 8.5, 1.0]), np.array([1.0, 0.05, 0.0]), rng)
        h2 = _helix_ca(plen - 40 - n_h, np.array([30.0, -8.5, 1.0]),
                       np.array([-1.0, 0.05, 0.0]), rng)
        floor = [_strand_ca(8, np.array([-16.0 + 1.0 * s, -14.0 + 7.0 * s, -7.5]),
                            np.array([1.0, 0.12 * (-1) ** s, 0.0]), rng) for s in range(5)]
        prot_ca = np.concatenate([h1, h2] + floor, axis=0)[:plen]
        prot_frames = _frames_from_ca_trace(prot_ca, rng)

        # ragged pocket: residues whose CA is near any peptide CA
        d = np.linalg.norm(prot_ca[:, None, :] - pep_ca[None, :, :], axis=-1).min(axis=1)
        cross = d < pocket_radius
        if cross.sum() == 0:
            cross[np.argsort(d)[:20]] = True
        if cross.sum() > 80:
            keep = np.argsort(d)[:80]
            cross = np.zeros_like(cross)
            cross[keep] = True

        aatype = rng.choice(20, size=L, p=_AA_FREQ)
        p_aatype = rng.choice(20, size=plen, p=_AA_FREQ)

        onehot = np.zeros((L, ONEHOT_WIDTH), dtype=np.float32)
        onehot[np.arange(L), aatype] = 1.0
        angles = rng.uniform(-np.pi, np.pi, size=(L, 7))
        peptide = {
            "backbone_rigid_tensor": pep_frames,
            "aatype": aatype,
            "sequence_onehot": onehot,
            "torsion_angles_sin_cos": np.stack(
                (np.sin(angles), np.cos(angles)), axis=-1).astype(np.float32),
            "torsion_angles_mask": chi_table[aatype],
        }
        p_onehot = np.zeros((plen, ONEHOT_WIDTH), dtype=np.float32)
        p_onehot[np.arange(plen), p_aatype] = 1.0
        atom14, exists = _atom14_from_frames(prot_frames, p_aatype, rng)
        protein = {
            "backbone_rigid_tensor": prot_frames,
            "aatype": p_aatype,
            "sequence_onehot": p_onehot,
            "atom14_gt_positions": atom14,
            "atom14_gt_exists": exists,
            "cross_residues_mask": cross,
        }
        yield f"REAL{i:04d}", {"peptide": peptide, "protein": protein}


def realistic_packed(n_entries: int, seed: int = 0) -> PackedDataset:
    """``realistic_entries(n_entries, seed=seed)`` packed without HDF5: the
    arrays a ``PackedDataset`` of the written file would hold."""
    raws = list(realistic_entries(n_entries, seed=seed))
    return PackedDataset.from_entries([pad_entry(n, r["peptide"], r["protein"]) for n, r in raws],
                                      [protein_arrays(r["protein"]) for _, r in raws])


def write_realistic_hdf5(path: str, n_entries: int = 8,
                         peptide_lengths: Sequence[int] = (8, 9, 10, 11),
                         protein_len_range=(150, 180), pocket_radius: float = 12.0,
                         seed: int = 0) -> None:
    """Write ``realistic_entries`` as a SwiftMHC-schema HDF5 file (needs h5py)."""
    import h5py

    with h5py.File(path, "w") as f5:
        for name, raw in realistic_entries(n_entries, peptide_lengths, protein_len_range,
                                           pocket_radius, seed):
            g = f5.create_group(name)
            for group_name, arrays in raw.items():
                grp = g.create_group(group_name)
                for key, value in arrays.items():
                    grp[key] = value
