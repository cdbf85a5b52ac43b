"""SwiftMHC-format HDF5 dataset -> fixed-shape numpy entry dicts.

Counterpart of ``pmhc_tpu/data/dataset.py`` with its exact padding policy:

- peptide padded to 16 with identity 4x4 frames;
- pocket = the rows of the MHC protein where ``cross_residues_mask`` is
  set, packed to the front of 80-row buffers: frames identity-padded,
  atom14/onehot/aatype zero-padded;
- torsion mask: backbone torsions (pre-omega, phi, psi) disabled, except
  psi (index 2) on the last residue; masked torsion slots hold the
  identity (sin, cos) = (0, 1);
- frames converted 4x4 -> tensor-7 (quat || translation, w >= 0).

``pad_entry`` applies the policy to one entry's ``peptide`` and
``protein`` groups, which may be h5py groups or dicts of numpy arrays
(``realistic.realistic_entries`` yields the latter), so a packed file
built without HDF5 holds the same arrays as one packed from the file.
``h5py`` is imported only where a file is read.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Sequence

import numpy as np

from pmhc_tpu_torch.data.synthetic import (
    ONEHOT_WIDTH,
    PEPTIDE_MAXLEN,
    POCKET_MAXLEN,
    frames_4x4_to_tensor7,
)

N_TORSIONS = 7
PROTEIN_KEYS = ("protein_aatype", "protein_atom14_positions", "protein_atom14_exists")


def pad_entry(entry_name: str, peptide: Mapping, mhc: Mapping) -> Dict[str, np.ndarray]:
    """One entry's padded arrays from its ``peptide`` and ``protein`` groups."""
    pocket_sel = mhc["cross_residues_mask"][:].astype(bool)
    n_pocket = int(pocket_sel.sum())
    if n_pocket > POCKET_MAXLEN:
        raise ValueError(f"{entry_name}: pocket has {n_pocket} residues > {POCKET_MAXLEN}")

    peptide_len = peptide["backbone_rigid_tensor"].shape[0]
    if peptide_len > PEPTIDE_MAXLEN:
        raise ValueError(f"{entry_name}: peptide has {peptide_len} residues > {PEPTIDE_MAXLEN}")

    frames = np.broadcast_to(np.eye(4, dtype=np.float32), (PEPTIDE_MAXLEN, 4, 4)).copy()
    frames[:peptide_len] = peptide["backbone_rigid_tensor"][:]

    pocket_frames = np.broadcast_to(np.eye(4, dtype=np.float32), (POCKET_MAXLEN, 4, 4)).copy()
    pocket_frames[:n_pocket] = mhc["backbone_rigid_tensor"][:][pocket_sel]
    pocket_atoms = np.zeros((POCKET_MAXLEN, 14, 3), dtype=np.float32)
    pocket_atoms[:n_pocket] = mhc["atom14_gt_positions"][:][pocket_sel]
    pocket_atoms_exist = np.zeros((POCKET_MAXLEN, 14), dtype=bool)
    pocket_atoms_exist[:n_pocket] = mhc["atom14_gt_exists"][:][pocket_sel]
    pocket_aatype = np.zeros(POCKET_MAXLEN, dtype=np.int32)
    pocket_aatype[:n_pocket] = mhc["aatype"][:][pocket_sel]
    pocket_onehot = np.zeros((POCKET_MAXLEN, ONEHOT_WIDTH), dtype=np.float32)
    pocket_onehot[:n_pocket] = mhc["sequence_onehot"][:][pocket_sel]
    pocket_mask = np.zeros(POCKET_MAXLEN, dtype=bool)
    pocket_mask[:n_pocket] = True

    mask = np.zeros(PEPTIDE_MAXLEN, dtype=bool)
    mask[:peptide_len] = True
    aatype = np.zeros(PEPTIDE_MAXLEN, dtype=np.int32)
    aatype[:peptide_len] = peptide["aatype"][:]
    onehot = np.zeros((PEPTIDE_MAXLEN, ONEHOT_WIDTH), dtype=np.float32)
    onehot[:peptide_len] = peptide["sequence_onehot"][:]

    torsions = np.zeros((PEPTIDE_MAXLEN, N_TORSIONS, 2), dtype=np.float32)
    torsions[:peptide_len] = peptide["torsion_angles_sin_cos"][:]
    torsions_mask = np.zeros((PEPTIDE_MAXLEN, N_TORSIONS), dtype=bool)
    torsions_mask[:peptide_len] = peptide["torsion_angles_mask"][:].astype(bool)
    torsions_mask[:, :3] = False
    torsions_mask[peptide_len - 1, 2] = True
    torsions[~torsions_mask] = np.array([0.0, 1.0], dtype=np.float32)

    return {
        "name": entry_name,
        "mask": mask,
        "frames": frames_4x4_to_tensor7(frames),
        "features": onehot,
        "aatype": aatype,
        "torsions": torsions,
        "torsions_mask": torsions_mask,
        "pocket_aatype": pocket_aatype,
        "pocket_features": pocket_onehot,
        "pocket_mask": pocket_mask,
        "pocket_frames": frames_4x4_to_tensor7(pocket_frames),
        "pocket_atom14_positions": pocket_atoms,
        "pocket_atom14_exists": pocket_atoms_exist,
    }


def protein_arrays(mhc: Mapping) -> Dict[str, np.ndarray]:
    """The full protein (not pocket-packed) of one entry, for PDB output."""
    return {
        "protein_aatype": mhc["aatype"][:].astype(np.int32),
        "protein_atom14_positions": mhc["atom14_gt_positions"][:].astype(np.float32),
        "protein_atom14_exists": mhc["atom14_gt_exists"][:].astype(bool),
    }


def stack_proteins(proteins: Sequence[Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack ``protein_arrays`` results, each zero-padded (exists False) to
    the longest of them."""
    max_len = max(p["protein_aatype"].shape[0] for p in proteins)

    def pad(a):
        n = a.shape[0]
        if n == max_len:
            return a
        return np.concatenate((a, np.zeros((max_len - n,) + a.shape[1:], dtype=a.dtype)))

    return {k: np.stack([pad(p[k]) for p in proteins]) for k in PROTEIN_KEYS}


class PmhcDataset:
    """Random-access dataset over one SwiftMHC HDF5 file. Entry names follow
    the file's key order. Thread-safe: each thread opens its own h5py
    handle (h5py releases the GIL during I/O, so the loader's thread pool
    overlaps reads)."""

    peptide_maxlen = PEPTIDE_MAXLEN
    pocket_maxlen = POCKET_MAXLEN

    def __init__(self, hdf5_path: str):
        import h5py

        self.hdf5_path = hdf5_path
        self._local = threading.local()
        with h5py.File(hdf5_path, "r") as f5:
            self.entry_names: List[str] = list(f5.keys())

    @property
    def _file(self):
        f = getattr(self._local, "file", None)
        if f is None:
            import h5py

            f = h5py.File(self.hdf5_path, "r")
            self._local.file = f
        return f

    def __len__(self) -> int:
        return len(self.entry_names)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_entry(self.entry_names[index])

    def get_entry(self, entry_name: str) -> Dict[str, np.ndarray]:
        entry = self._file[entry_name]
        if "peptide" not in entry:
            raise ValueError(f"no peptide in {entry_name}")
        return pad_entry(entry_name, entry["peptide"], entry["protein"])

    def get_protein(self, entry_name: str) -> Dict[str, np.ndarray]:
        return protein_arrays(self._file[entry_name]["protein"])

    def get_protein_positions(self, entry_names: List[str]) -> Dict[str, np.ndarray]:
        """Full-protein atom data of ``entry_names`` for PDB output, padded
        to the longest protein among them with exists False."""
        return stack_proteins([self.get_protein(n) for n in entry_names])
