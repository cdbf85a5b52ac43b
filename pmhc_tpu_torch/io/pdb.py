"""PDB writer: sampled frames + torsions -> all-atom PDB bytes.

Counterpart of ``pmhc_tpu/io/pdb.py``; the bytes are identical to the JAX
package's for the same arrays.

- chain P: the peptide. Backbone-group atoms placed by applying the
  (re-normalized) residue frame to literature positions; side-chain atoms
  beyond atom14 slot 4 from the idealized atom14 coordinates; each
  residue's backbone O from the previous residue's CA/C and this
  residue's N; the terminal residue gets O from the psi-group frame and a
  mirrored OXT (bounds checked before the mask lookup).
- chain M: the full protein from its stored atom14 coordinates.

Records follow BioPython PDBIO's layout: sequential renumbering in file
order, segid = chain id, a TER per chain whose serial is shared with the
next chain's first atom, and END.

Each chain's ATOM records are written at once from packed field arrays
(``_emit_atoms``), as the JAX package's writer does: by the native
formatter (``io/pdb_native.py``, a g++ build of ``csrc/pdb_formatter.cc``;
a failed build raises), or by Python's formatter when
``PMHC_PDB_FORMATTER=python`` asks for it. Both write the same bytes.
Chain M's record fields come from per-(residue type, atom14 slot) tables.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict

import numpy as np
import torch

from pmhc_tpu_torch import constants as rc
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.io.atoms import (
    BACKBONE_GROUP,
    PSI_GROUP,
    frames_to_atom14_positions,
    torsion_angles_to_frames,
)


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-12)


def _ter_record(serial, resname, chain, resseq) -> str:
    return f"TER   {serial:>5}      {resname:>3} {chain}{resseq:>4} ".ljust(80) + "\n"


@functools.lru_cache(maxsize=None)
def _name_fields(name: str):
    """(4-byte name field, 2-byte element field) as uint8 arrays, PDBIO's
    padding rules: a short name gets a leading space and is left-justified
    to 4; the element is the name's first letter, right-justified to 2."""
    field = (" " + name).ljust(4)[:4] if len(name) < 4 else name[:4]
    return (np.frombuffer(field.encode(), np.uint8),
            np.frombuffer(f"{name[0]:>2}".encode(), np.uint8))


def _res3(aa_name: str) -> np.ndarray:
    return np.frombuffer(f"{aa_name:>3}".encode(), np.uint8)


def _build_atom14_tables():
    """Chain M's static record fields per (residue type, atom14 slot): the
    name and element fields, whether the slot holds an atom, and the
    residue name per type."""
    R = len(rc.restypes)
    names4 = np.full((R, 14, 4), ord(" "), np.uint8)
    elems2 = np.full((R, 14, 2), ord(" "), np.uint8)
    valid = np.zeros((R, 14), bool)
    res3 = np.zeros((R, 3), np.uint8)
    for r, rt in enumerate(rc.restypes):
        aa = rc.restype_1to3[rt]
        res3[r] = _res3(aa)
        for s, name in enumerate(rc.restype_name_to_atom14_names[aa]):
            if name.strip():
                names4[r, s], elems2[r, s] = _name_fields(name)
                valid[r, s] = True
    return names4, elems2, valid, res3


_A14_NAMES4, _A14_ELEMS2, _A14_VALID, _RES3 = _build_atom14_tables()


def _emit_atoms(serial_start: int, chain: str, names4, resnames3, elements2, resseqs,
                xyz) -> bytes:
    """All ATOM records of one chain, numbered from ``serial_start + 1``,
    from packed field arrays: ``names4`` uint8 [n, 4], ``resnames3`` uint8
    [n, 3], ``elements2`` uint8 [n, 2], ``resseqs`` int [n], ``xyz``
    float64 [n, 3]. The native formatter unless ``PMHC_PDB_FORMATTER=python``."""
    n = len(resseqs)
    xyz = np.asarray(xyz, np.float64)
    if os.environ.get("PMHC_PDB_FORMATTER") != "python":
        from pmhc_tpu_torch.io import pdb_native

        serials = np.arange(serial_start + 1, serial_start + n + 1, dtype=np.int32)
        return pdb_native.format_atoms(serials, np.asarray(resseqs, np.int32), chain,
                                       np.asarray(names4), np.asarray(resnames3),
                                       np.asarray(elements2), xyz)
    nm = np.asarray(names4).tobytes().decode()
    rs = np.asarray(resnames3).tobytes().decode()
    el = np.asarray(elements2).tobytes().decode()
    sq = np.asarray(resseqs).tolist()
    ch4 = f"{chain:>4}"
    return "".join(
        f"ATOM  {k:>5} {nm[4*j:4*j+4]} {rs[3*j:3*j+3]} {chain}{sq[j]:>4}    "
        f"{xyz[j, 0]:8.3f}{xyz[j, 1]:8.3f}{xyz[j, 2]:8.3f}"
        f"  1.00  0.00      {ch4}{el[2*j:2*j+2]}  \n"
        for j, k in enumerate(range(serial_start + 1, serial_start + n + 1))).encode()


@functools.lru_cache(maxsize=4)
def _residue_tables(device: torch.device):
    """The residue tables the conversion reads, copied to ``device`` once:
    a copy from pageable host memory waits for the device's queued work,
    which would make a caller wait for the sampling it has just queued."""
    return tuple(torch.as_tensor(x, device=device) for x in (
        rc.restype_rigid_group_default_frame, rc.restype_atom14_to_rigid_group,
        rc.restype_atom14_mask, rc.restype_atom14_rigid_group_positions))


def convert_batch_for_pdb(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch-level torsion -> frames -> atom14 conversion, on the
    batch's device, once per batch (no host fetch here)."""
    frames: RigidArray = batch["frames"]
    dev = frames.quats.device
    aatype = torch.as_tensor(batch["aatype"], device=dev)
    default_frames, to_group, atom_mask, group_positions = _residue_tables(dev)
    group_rots, group_trans = torsion_angles_to_frames(
        frames, batch["torsions"], aatype, default_frames)
    atom14 = frames_to_atom14_positions(
        group_rots, group_trans, aatype, to_group, atom_mask, group_positions)
    return {
        "aatype": batch["aatype"],
        "mask": batch["mask"],
        "quats": frames.quats,
        "trans": frames.trans,
        "atom14": atom14,
        "group_rots": group_rots,
        "group_trans": group_trans,
        "protein_aatype": batch["protein_aatype"],
        "protein_atom14_positions": batch["protein_atom14_positions"],
        "protein_atom14_exists": batch["protein_atom14_exists"],
    }


def fetch_pdb_arrays(conv: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fetch a ``convert_batch_for_pdb`` result to host numpy."""
    pc = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in conv.items()}
    pc["mask"] = pc["mask"].astype(bool)
    pc["protein_atom14_exists"] = pc["protein_atom14_exists"].astype(bool)
    return pc


def precompute_pdb_arrays(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The batch-level conversion, once, fetched to host numpy: pass it as
    ``precomputed`` when writing many entries of one batch."""
    return fetch_pdb_arrays(convert_batch_for_pdb(batch))


def save_pdb(batch: Dict[str, Any] | None, batch_index: int, path: str,
             precomputed: Dict[str, np.ndarray] | None = None) -> None:
    """Write one complex as a PDB file: the bytes of ``pdb_bytes``."""
    data = pdb_bytes(batch, batch_index, precomputed)
    with open(path, "wb") as f:
        f.write(data)


def pdb_bytes(batch: Dict[str, Any] | None, batch_index: int,
              precomputed: Dict[str, np.ndarray] | None = None) -> bytes:
    """The PDB file contents of one complex (peptide chain P + protein
    chain M). Pass ``precomputed=precompute_pdb_arrays(batch)`` when
    writing many entries of one batch."""
    pc = precomputed if precomputed is not None else precompute_pdb_arrays(batch)

    b = batch_index
    aatype = pc["aatype"][b]
    mask = pc["mask"][b]
    quats = _normalize(pc["quats"][b])
    trans = pc["trans"][b]
    atom14_np = pc["atom14"][b]
    group_rots_np = pc["group_rots"][b]
    group_trans_np = pc["group_trans"][b]
    n_res = aatype.shape[0]

    def apply_frame(i: int, p) -> np.ndarray:
        w, x, y, z = quats[i]
        m = np.array(
            [
                [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
            ]
        )
        return m @ np.asarray(p, dtype=np.float64) + trans[i]

    atom_pos: Dict[tuple, np.ndarray] = {}
    residue_atoms: Dict[int, list] = {}

    def add_atom(res_idx: int, name: str, pos) -> None:
        pos = np.asarray(pos, dtype=np.float64)
        residue_atoms.setdefault(res_idx, []).append((name, pos))
        atom_pos[(res_idx, name)] = pos

    for i in range(n_res):
        if not mask[i]:
            continue
        aa_name = rc.restype_1to3[rc.restypes[int(aatype[i])]]
        for atom_name, group_id, p in rc.rigid_group_atom_positions[aa_name]:
            if group_id == BACKBONE_GROUP:
                add_atom(i, atom_name, apply_frame(i, p))
        for atom_idx, atom_name in enumerate(rc.restype_name_to_atom14_names[aa_name]):
            if atom_idx > 4 and atom_name.strip():
                add_atom(i, atom_name, atom14_np[i, atom_idx])
        # previous residue's backbone O from CA/C/N geometry
        if i > 0 and mask[i - 1]:
            cac = _normalize(atom_pos[(i - 1, "C")] - atom_pos[(i - 1, "CA")])
            nc = _normalize(atom_pos[(i - 1, "C")] - atom_pos[(i, "N")])
            co = _normalize(cac + nc) * 1.24
            add_atom(i - 1, "O", atom_pos[(i - 1, "C")] + co)
        # terminal residue: psi-frame O + mirrored OXT
        if (i + 1 >= n_res) or (not mask[i + 1]):
            c = atom_pos[(i, "C")]
            cac = _normalize(c - atom_pos[(i, "CA")])
            for atom_name, group_id, p in rc.rigid_group_atom_positions[aa_name]:
                if group_id == PSI_GROUP and atom_name == "O":
                    o = group_rots_np[i, PSI_GROUP] @ np.asarray(p, dtype=np.float64) \
                        + group_trans_np[i, PSI_GROUP]
                    add_atom(i, "O", o)
                    co = o - c
                    co_proj = cac * np.sum(co * cac)
                    add_atom(i, "OXT", c + co_proj - (co - co_proj))

    # chain P in residue order, renumbered in file order
    parts = []
    fields = []  # (name4, element2, res3, resseq, xyz) per atom
    last = None
    for i in sorted(residue_atoms):
        aa_name = rc.restype_1to3[rc.restypes[int(aatype[i])]]
        for name, pos in residue_atoms[i]:
            fields.append((*_name_fields(name), _res3(aa_name), i + 1, pos))
        last = (aa_name, i + 1)
    serial = len(fields)
    if fields:
        names4, elems2, res3, resseq, xyz = zip(*fields)
        parts.append(_emit_atoms(0, "P", np.stack(names4), np.stack(res3), np.stack(elems2),
                                 np.asarray(resseq, np.int32), np.stack(xyz)))
    if last is not None:
        # the TER serial (last atom + 1) is shared with chain M's first atom
        parts.append(_ter_record(serial + 1, last[0], "P", last[1]).encode())

    # chain M: np.nonzero's row-major order is the per-residue, per-slot order
    p_aatype = pc["protein_aatype"][b].astype(np.int64)
    p_pos = pc["protein_atom14_positions"][b]
    p_exists = pc["protein_atom14_exists"][b]
    if p_aatype.shape[0]:
        ri, ai = np.nonzero(p_exists & _A14_VALID[p_aatype])
        if ri.size:
            parts.append(_emit_atoms(serial, "M", _A14_NAMES4[p_aatype[ri], ai],
                                     _RES3[p_aatype[ri]], _A14_ELEMS2[p_aatype[ri], ai],
                                     (ri + 1).astype(np.int32), p_pos[ri, ai].astype(np.float64)))
            serial += int(ri.size)
        last_m = rc.restype_1to3[rc.restypes[int(p_aatype[-1])]]
        parts.append(_ter_record(serial + 1, last_m, "M", p_aatype.shape[0]).encode())
    parts.append(b"END\n")
    return b"".join(parts)
