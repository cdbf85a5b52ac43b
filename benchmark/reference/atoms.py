"""The reference's atoms: a sampled peptide's frames and torsions to the atoms
of its PDB chain P, and the PDB text read back.

numpy in float64, from the public AlphaFold residue tables (copied beside this
file: ``residue_tables.npz``, ``residue_names.json``). Chain P, as the published
writer lays it out: per residue the backbone group's atoms from the normalised
frame applied to their literature positions, the side-chain atoms past atom14
slot 4 from the torsion frames, each residue's O from the previous CA, C and
this N, and on the last residue O from the psi frame with a mirrored OXT.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_T = np.load(os.path.join(_DIR, "residue_tables.npz"))
DEFAULT_FRAMES = _T["restype_rigid_group_default_frame"].astype(np.float64)
ATOM14_GROUP = _T["restype_atom14_to_rigid_group"].astype(np.int64)
ATOM14_MASK = _T["restype_atom14_mask"].astype(np.float64)
ATOM14_POSITIONS = _T["restype_atom14_rigid_group_positions"].astype(np.float64)
with open(os.path.join(_DIR, "residue_names.json")) as _f:
    _N = json.load(_f)
RESTYPES = _N["restypes"]
ONE_TO_THREE = _N["restype_1to3"]
ATOM14_NAMES = _N["restype_name_to_atom14_names"]
GROUP_ATOMS = _N["rigid_group_atom_positions"]  # resname -> [(atom, group, xyz)]

Atom = Tuple[str, str, int, np.ndarray]  # (atom name, residue name, residue number, xyz)


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _rot(q):
    w, x, y, z = q
    return np.array([[w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z]])


def group_frames(q: np.ndarray, t: np.ndarray, tors: np.ndarray, aatype: np.ndarray):
    """The 8 rigid-group frames of every residue in global coordinates, from
    the raw frame (unnormalised, as the published conversion takes it) and
    the raw (sin, cos) torsions: (rots [N, 8, 3, 3], trans [N, 8, 3])."""
    n = len(aatype)
    rots = np.zeros((n, 8, 3, 3))
    trs = np.zeros((n, 8, 3))
    for i in range(n):
        d = DEFAULT_FRAMES[aatype[i]]
        alpha = np.concatenate(([[0.0, 1.0]], tors[i]), 0)
        g_rot, g_tr = [], []
        for k in range(8):
            s, c = alpha[k]
            x = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
            g_rot.append(d[k, :3, :3] @ x)
            g_tr.append(d[k, :3, 3].copy())
        for k in (5, 6, 7):
            g_tr[k] = g_rot[k - 1] @ g_tr[k] + g_tr[k - 1]
            g_rot[k] = g_rot[k - 1] @ g_rot[k]
        bb = _rot(q[i])
        rots[i] = [bb @ r for r in g_rot]
        trs[i] = [bb @ x + t[i] for x in g_tr]
    return rots, trs


def peptide_atoms(q: np.ndarray, t: np.ndarray, tors: np.ndarray, aatype: np.ndarray,
                  mask: np.ndarray) -> List[Atom]:
    """Chain P's atoms in file order for one sampled peptide."""
    q, t, tors = (np.asarray(x, np.float64) for x in (q, t, tors))
    rots, trs = group_frames(q, t, tors, aatype)
    qn = _unit(q)
    residues: Dict[int, list] = {}
    pos: Dict[tuple, np.ndarray] = {}

    def add(i, name, xyz):
        residues.setdefault(i, []).append((name, xyz))
        pos[(i, name)] = xyz

    n = len(aatype)
    for i in range(n):
        if not mask[i]:
            continue
        aa = ONE_TO_THREE[RESTYPES[int(aatype[i])]]
        for name, group, p in GROUP_ATOMS[aa]:
            if group == 0:
                add(i, name, _rot(qn[i]) @ np.asarray(p, np.float64) + t[i])
        for slot, name in enumerate(ATOM14_NAMES[aa]):
            if slot > 4 and name.strip():
                g = ATOM14_GROUP[aatype[i], slot]
                xyz = rots[i, g] @ ATOM14_POSITIONS[aatype[i], slot] + trs[i, g]
                add(i, name, xyz * ATOM14_MASK[aatype[i], slot])
        if i > 0 and mask[i - 1]:
            cac = _unit(pos[(i - 1, "C")] - pos[(i - 1, "CA")])
            nc = _unit(pos[(i - 1, "C")] - pos[(i, "N")])
            add(i - 1, "O", pos[(i - 1, "C")] + _unit(cac + nc) * 1.24)
        if i + 1 >= n or not mask[i + 1]:
            c = pos[(i, "C")]
            cac = _unit(c - pos[(i, "CA")])
            for name, group, p in GROUP_ATOMS[aa]:
                if group == 3 and name == "O":
                    o = rots[i, 3] @ np.asarray(p, np.float64) + trs[i, 3]
                    add(i, "O", o)
                    co = o - c
                    proj = cac * np.sum(co * cac)
                    add(i, "OXT", c + proj - (co - proj))
    out = []
    for i in sorted(residues):
        aa = ONE_TO_THREE[RESTYPES[int(aatype[i])]]
        out += [(name, aa, i + 1, xyz) for name, xyz in residues[i]]
    return out


def protein_atoms(aatype: np.ndarray, xyz: np.ndarray, exists: np.ndarray) -> List[Atom]:
    """Chain M's atoms in file order: every existing atom14 slot of a real
    atom, residue by residue."""
    out = []
    for i, a in enumerate(aatype):
        aa = ONE_TO_THREE[RESTYPES[int(a)]]
        for slot, name in enumerate(ATOM14_NAMES[aa]):
            if name.strip() and exists[i, slot]:
                out.append((name, aa, i + 1, np.asarray(xyz[i, slot], np.float64)))
    return out


def read_pdb(text: bytes) -> Dict[str, List[Atom]]:
    """The ATOM records of a PDB by chain: (name, residue, number, xyz)."""
    chains: Dict[str, List[Atom]] = {}
    for line in text.decode().splitlines():
        if line.startswith("ATOM  "):
            chains.setdefault(line[21], []).append(
                (line[12:16].strip(), line[17:20].strip(), int(line[22:26]),
                 np.array([float(line[30:38]), float(line[38:46]), float(line[46:54])])))
    return chains


def atoms_gap(got: List[Atom], want: List[Atom]) -> float:
    """The largest distance in A between an atom read and the reference's;
    infinite where the atoms' names, residues or count differ."""
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for (n1, r1, s1, x1), (n2, r2, s2, x2) in zip(got, want):
        if (n1, r1, s1) != (n2, r2, s2):
            return float("inf")
        worst = max(worst, float(np.linalg.norm(x1 - x2)))
    return worst
