"""SwiftMHC-format HDF5 schema validator.

Counterpart of ``pmhc_tpu/data/validate.py``, with its checks and
messages: a user's file is held against everything the reader assumes,
and each problem is reported as one actionable message instead of a
mid-epoch stack trace.

Checked per entry:

- groups ``peptide`` and ``protein`` exist;
- peptide datasets ``backbone_rigid_tensor`` (P,4,4), ``aatype`` (P,),
  ``sequence_onehot`` (P,22), ``torsion_angles_sin_cos`` (P,7,2),
  ``torsion_angles_mask`` (P,7) with one consistent P,
  1 <= P <= peptide_maxlen (16);
- protein datasets ``backbone_rigid_tensor`` (M,4,4), ``aatype`` (M,),
  ``sequence_onehot`` (M,22), ``atom14_gt_positions`` (M,14,3),
  ``atom14_gt_exists`` (M,14), ``cross_residues_mask`` (M) with one
  consistent M, and 1 <= sum(cross_residues_mask) <= pocket_maxlen (80);
- dtype classes: float-castable for float data, integer for aatype,
  bool/integer/float for masks (the reader casts; other widths are
  flagged only in ``strict`` mode);
- values: aatype in [0, 21]; all floats finite; the 4x4 frames' bottom
  row is [0,0,0,1] and the rotation block orthonormal to 1e-2.

The schema check reads HDF5 (h5py); run it before packing a file.
``validate_or_exit`` is the CLIs' ``--validate-data``.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

from pmhc_tpu_torch.data.synthetic import ONEHOT_WIDTH, PEPTIDE_MAXLEN, POCKET_MAXLEN

_log = logging.getLogger(__name__)

N_TORSIONS = 7

_PEPTIDE_DSETS = {
    "backbone_rigid_tensor": ("f", (4, 4)),
    "aatype": ("i", ()),
    "sequence_onehot": ("f", (ONEHOT_WIDTH,)),
    "torsion_angles_sin_cos": ("f", (N_TORSIONS, 2)),
    "torsion_angles_mask": ("b", (N_TORSIONS,)),
}
_PROTEIN_DSETS = {
    "backbone_rigid_tensor": ("f", (4, 4)),
    "aatype": ("i", ()),
    "sequence_onehot": ("f", (ONEHOT_WIDTH,)),
    "atom14_gt_positions": ("f", (14, 3)),
    "atom14_gt_exists": ("b", (14,)),
    "cross_residues_mask": ("b", ()),
}


def _check_group(entry_name, group, gname, spec, problems, strict):
    """Shape/dtype checks for one group; returns the leading dim or None."""
    lead = None
    for dname, (kind, tail) in spec.items():
        path = f"{entry_name}/{gname}/{dname}"
        if dname not in group:
            problems.append(f"{path}: missing dataset")
            continue
        d = group[dname]
        shape = tuple(d.shape)
        if len(shape) != 1 + len(tail) or shape[1:] != tail:
            problems.append(
                f"{path}: shape {shape}, expected (N,{','.join(map(str, tail))})"
                if tail else f"{path}: shape {shape}, expected (N,)")
            continue
        if lead is None:
            lead = shape[0]
        elif shape[0] != lead:
            problems.append(
                f"{path}: leading dim {shape[0]} != {lead} of the other "
                f"{gname} datasets")
        k = d.dtype.kind
        if kind == "f" and k not in "f":
            problems.append(f"{path}: dtype {d.dtype}, expected a float type")
        elif kind == "i" and k not in "iu":
            problems.append(f"{path}: dtype {d.dtype}, expected an integer type")
        elif kind == "b" and k not in "biuf":
            # the readers cast masks with .astype(bool), so bool, integer
            # AND float (0.0/1.0) variants all load — reject only types
            # that cannot cast
            problems.append(
                f"{path}: dtype {d.dtype}, expected bool/integer/float")
        elif strict and kind == "b" and k == "f":
            problems.append(
                f"{path}: dtype {d.dtype} (accepted; bool is canonical)")
        elif strict and kind == "f" and d.dtype != np.float32:
            problems.append(
                f"{path}: dtype {d.dtype} (accepted; float32 is canonical)")
    return lead


def _check_frames(path, frames, problems):
    if not np.isfinite(frames).all():
        problems.append(f"{path}: non-finite values")
        return
    bottom = frames[:, 3, :]
    if not np.allclose(bottom, np.array([0.0, 0.0, 0.0, 1.0]), atol=1e-4):
        problems.append(
            f"{path}: 4x4 bottom row is not [0,0,0,1] "
            f"(max dev {np.abs(bottom - [0, 0, 0, 1]).max():.2e}) — not an "
            "affine rigid tensor")
        return
    rot = frames[:, :3, :3]
    rtr = np.einsum("nij,nkj->nik", rot, rot)
    dev = np.abs(rtr - np.eye(3)).max()
    if dev > 1e-2:
        problems.append(
            f"{path}: rotation block not orthonormal (max |R R^T - I| = "
            f"{dev:.2e}) — frames may be stored transposed or unnormalized")


def validate_hdf5(
    path: str, max_entries: int | None = None, strict: bool = False,
) -> Tuple[int, List[str]]:
    """Validate a SwiftMHC-format HDF5 file against the reader's schema.

    Returns ``(entries_checked, problems)`` where each problem is one
    actionable message. An empty problem list means every checked entry
    loads cleanly through ``PmhcDataset`` and the reference reader."""
    import h5py

    problems: List[str] = []
    with h5py.File(path, "r") as f5:
        names = list(f5.keys())
        if not names:
            return 0, [f"{path}: file contains no entries"]
        if max_entries is not None:
            names = names[:max_entries]
        for name in names:
            entry = f5[name]
            if "peptide" not in entry:
                problems.append(f"{name}: missing 'peptide' group")
                continue
            if "protein" not in entry:
                problems.append(f"{name}: missing 'protein' group")
                continue
            before = len(problems)
            p_len = _check_group(
                name, entry["peptide"], "peptide", _PEPTIDE_DSETS,
                problems, strict)
            m_len = _check_group(
                name, entry["protein"], "protein", _PROTEIN_DSETS,
                problems, strict)
            if len(problems) != before:
                continue  # shape/dtype problems: skip the value checks

            if not 1 <= p_len <= PEPTIDE_MAXLEN:
                problems.append(
                    f"{name}/peptide: length {p_len} outside [1, "
                    f"{PEPTIDE_MAXLEN}] (reference pads to "
                    f"peptide_maxlen={PEPTIDE_MAXLEN}, data.py:15)")
            pocket_n = int(
                np.asarray(entry["protein/cross_residues_mask"][:])
                .astype(bool).sum())
            if not 1 <= pocket_n <= POCKET_MAXLEN:
                problems.append(
                    f"{name}/protein: cross_residues_mask selects "
                    f"{pocket_n} pocket residues, outside [1, "
                    f"{POCKET_MAXLEN}] (reference packs into "
                    f"pocket_maxlen={POCKET_MAXLEN}, data.py:16)")

            for gname in ("peptide", "protein"):
                aatype = np.asarray(entry[f"{gname}/aatype"][:])
                if aatype.size and (aatype.min() < 0 or aatype.max() > 21):
                    problems.append(
                        f"{name}/{gname}/aatype: values outside [0, 21] "
                        f"(min {aatype.min()}, max {aatype.max()})")
                _check_frames(
                    f"{name}/{gname}/backbone_rigid_tensor",
                    np.asarray(entry[f"{gname}/backbone_rigid_tensor"][:],
                               dtype=np.float64),
                    problems)
                oh = np.asarray(entry[f"{gname}/sequence_onehot"][:])
                if not np.isfinite(oh).all():
                    problems.append(
                        f"{name}/{gname}/sequence_onehot: non-finite values")
            tors = np.asarray(entry["peptide/torsion_angles_sin_cos"][:])
            if not np.isfinite(tors).all():
                problems.append(
                    f"{name}/peptide/torsion_angles_sin_cos: non-finite")
            atoms = np.asarray(entry["protein/atom14_gt_positions"][:])
            if not np.isfinite(atoms).all():
                problems.append(
                    f"{name}/protein/atom14_gt_positions: non-finite")
    return len(names), problems


def validate_or_exit(path: str) -> None:
    """``--validate-data``: log every problem of ``path`` and raise
    ``SystemExit`` if there is one. A packed ``.npz`` raises too: the
    schema check reads HDF5."""
    if path.endswith(".npz"):
        raise SystemExit(f"{path}: --validate-data checks the HDF5 schema and cannot read a "
                         "packed .npz; validate the HDF5 file before packing it")
    checked, problems = validate_hdf5(path)
    for prob in problems:
        _log.error("schema: %s", prob)
    if problems:
        raise SystemExit(f"{path}: {len(problems)} schema problems in {checked} entries "
                         "(see above)")
    _log.info("schema: %d entries validated clean", checked)
