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
"""

from __future__ import annotations

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


def _name_fields(name: str):
    """(4-char name field, 2-char element field), PDBIO padding rules."""
    field = (" " + name).ljust(4)[:4] if len(name) < 4 else name[:4]
    return field, f"{name[0]:>2}"


def _atom_record(serial: int, name: str, resname: str, chain: str, resseq: int, xyz) -> str:
    nm, el = _name_fields(name)
    return (f"ATOM  {serial:>5} {nm} {resname:>3} {chain}{resseq:>4}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
            f"  1.00  0.00      {chain:>4}{el}  \n")


def convert_batch_for_pdb(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch-level torsion -> frames -> atom14 conversion, on the
    batch's device, once per batch (no host fetch here)."""
    frames: RigidArray = batch["frames"]
    dev = frames.quats.device
    table = lambda x: torch.as_tensor(x, device=dev)
    aatype = torch.as_tensor(batch["aatype"], device=dev)
    group_rots, group_trans = torsion_angles_to_frames(
        frames, batch["torsions"], aatype, table(rc.restype_rigid_group_default_frame))
    atom14 = frames_to_atom14_positions(
        group_rots, group_trans, aatype,
        table(rc.restype_atom14_to_rigid_group), table(rc.restype_atom14_mask),
        table(rc.restype_atom14_rigid_group_positions))
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

    lines = []
    serial = 0
    last = None
    for i in sorted(residue_atoms):
        aa_name = rc.restype_1to3[rc.restypes[int(aatype[i])]]
        for name, pos in residue_atoms[i]:
            serial += 1
            lines.append(_atom_record(serial, name, aa_name, "P", i + 1, pos))
        last = (aa_name, i + 1)
    if last is not None:
        # the TER serial (last atom + 1) is shared with chain M's first atom
        lines.append(_ter_record(serial + 1, last[0], "P", last[1]))

    p_aatype = pc["protein_aatype"][b].astype(np.int64)
    p_pos = pc["protein_atom14_positions"][b].astype(np.float64)
    p_exists = pc["protein_atom14_exists"][b]
    if p_aatype.shape[0]:
        for r, rt in enumerate(p_aatype):
            aa_name = rc.restype_1to3[rc.restypes[int(rt)]]
            for s, name in enumerate(rc.restype_name_to_atom14_names[aa_name]):
                if p_exists[r, s] and name.strip():
                    serial += 1
                    lines.append(_atom_record(serial, name, aa_name, "M", r + 1, p_pos[r, s]))
        last_m = rc.restype_1to3[rc.restypes[int(p_aatype[-1])]]
        lines.append(_ter_record(serial + 1, last_m, "M", p_aatype.shape[0]))
    lines.append("END\n")
    return "".join(lines).encode()
