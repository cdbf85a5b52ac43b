"""The benchmark's inputs, made from ``--seed``: pMHC complexes shaped as real
SwiftMHC exports are.

A frozen, vectorised copy of the system's realistic-entry generator
(``data/realistic.py``), so that a change to the program cannot change what is
measured: per complex an extended peptide strand of 8-11 residues in a groove
between two MHC helices above a sheet floor, an MHC of 150-180 residues, the
pocket those MHC residues whose CA lies within 12 A of a peptide CA (at least
20, at most 80), residue types at proteome frequencies, uniform torsion angles,
per-type torsion and atom14 masks, protein atoms from the literature
positions. The peptide lengths cycle 8, 9, 10, 11 over the pool, so every
seed gives the same mix of sizes.

``make_pool`` returns the complexes stacked in fixed shapes (peptide 16,
pocket 80, protein padded to 180): the arrays of the program's packed dataset
plus the full proteins. ``request_entry`` cuts one complex to a serving
request (``POST /sample``'s body).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.reference.atoms import ATOM14_GROUP, ATOM14_MASK, ATOM14_POSITIONS

PEPTIDE_MAX, POCKET_MAX, PROTEIN_MAX = 16, 80, 180
ONEHOT = 22
_AA_FREQ = np.array([8.3, 5.5, 4.0, 5.4, 1.4, 3.9, 6.8, 7.1, 2.3, 5.9,
                     9.7, 5.8, 2.4, 3.9, 4.7, 6.6, 5.3, 1.1, 2.9, 6.9])
_AA_FREQ = _AA_FREQ / _AA_FREQ.sum()


def _chi_table() -> np.ndarray:
    """[20, 7] torsion existence per residue type: omega, phi, psi always,
    chi_g where an atom14 slot of the type hangs off rigid group 4 + g."""
    out = np.zeros((20, 7), np.float32)
    out[:, :3] = 1.0
    for g in range(4):
        out[:, 3 + g] = ((ATOM14_GROUP[:20] == 4 + g) & (ATOM14_MASK[:20] > 0.5)).any(1)
    return out


def _frames(ca: np.ndarray, rng) -> np.ndarray:
    """Rotations [L, 3, 3] from a CA trace: x along the chain, z a smoothed normal."""
    fwd = np.zeros_like(ca)
    fwd[:-1] = ca[1:] - ca[:-1]
    fwd[-1] = fwd[-2]
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True) + 1e-9
    up = np.cross(fwd, np.roll(fwd, 1, axis=0)) + rng.normal(size=ca.shape) * 0.05
    up -= fwd * np.sum(up * fwd, -1, keepdims=True)
    n = np.linalg.norm(up, axis=-1, keepdims=True)
    up = np.where(n > 1e-6, up / (n + 1e-9), np.array([0.0, 0.0, 1.0]))
    return np.stack((fwd, np.cross(up, fwd), up), axis=-1)


def _helix(n, start, direction, rng):
    direction = direction / np.linalg.norm(direction)
    u = np.cross(direction, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    v = np.cross(direction, u)
    k = np.arange(n)[:, None]
    ang = np.deg2rad(100.0) * k
    ca = start + direction * 1.5 * k + u * 2.3 * np.cos(ang) + v * 2.3 * np.sin(ang)
    return ca + rng.normal(size=ca.shape) * 0.08


def _strand(n, start, direction, rng):
    direction = direction / np.linalg.norm(direction)
    k = np.arange(n)[:, None]
    ca = start + direction * 3.8 * k + np.array([0.0, 0.0, 0.5]) * (-1.0) ** k
    return ca + rng.normal(size=ca.shape) * 0.06


def _quats(rot: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] -> unit quaternions (w >= 0), the best
    conditioned of Shepperd's four forms."""
    m = rot
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = np.stack((
        np.stack((1 + tr, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                  m[..., 1, 0] - m[..., 0, 1]), -1),
        np.stack((m[..., 2, 1] - m[..., 1, 2], 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                  m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]), -1),
        np.stack((m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                  1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], m[..., 1, 2] + m[..., 2, 1]), -1),
        np.stack((m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                  m[..., 1, 2] + m[..., 2, 1], 1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]), -1),
    ), -2)
    diag = np.stack((1 + tr, 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]), -1)
    q = np.take_along_axis(cands, np.argmax(diag, -1)[..., None, None], -2)[..., 0, :]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[..., :1] < 0, -q, q)


def make_pool(n: int, seed: int) -> Dict[str, np.ndarray]:
    """``n`` complexes from ``seed``, stacked: the packed dataset's twelve
    arrays (frames as quaternion || translation) and the full proteins
    (``protein_aatype``, ``protein_atom14_positions``, ``protein_atom14_exists``,
    ``protein_len``)."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    chi = _chi_table()
    out = {
        "mask": np.zeros((n, PEPTIDE_MAX), bool),
        "frames": np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (n, PEPTIDE_MAX, 1)),
        "features": np.zeros((n, PEPTIDE_MAX, ONEHOT), np.float32),
        "aatype": np.zeros((n, PEPTIDE_MAX), np.int32),
        "torsions": np.tile(np.array([0, 1], np.float32), (n, PEPTIDE_MAX, 7, 1)),
        "torsions_mask": np.zeros((n, PEPTIDE_MAX, 7), bool),
        "pocket_aatype": np.zeros((n, POCKET_MAX), np.int32),
        "pocket_features": np.zeros((n, POCKET_MAX, ONEHOT), np.float32),
        "pocket_mask": np.zeros((n, POCKET_MAX), bool),
        "pocket_frames": np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (n, POCKET_MAX, 1)),
        "pocket_atom14_positions": np.zeros((n, POCKET_MAX, 14, 3), np.float32),
        "pocket_atom14_exists": np.zeros((n, POCKET_MAX, 14), bool),
        "protein_aatype": np.zeros((n, PROTEIN_MAX), np.int32),
        "protein_atom14_positions": np.zeros((n, PROTEIN_MAX, 14, 3), np.float32),
        "protein_atom14_exists": np.zeros((n, PROTEIN_MAX, 14), bool),
        "protein_len": np.zeros(n, np.int32),
    }
    lit_backbone = ATOM14_GROUP[:20] == 0
    for i in range(n):
        L = 8 + i % 4
        plen = int(rng.integers(150, 180))
        pep_ca = _strand(L, np.array([-1.9 * L, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]), rng)
        pep_rot = _frames(pep_ca, rng)
        n_h = (plen - 40) // 2
        floor = [_strand(8, np.array([-16.0 + s, -14.0 + 7.0 * s, -7.5]),
                         np.array([1.0, 0.12 * (-1) ** s, 0.0]), rng) for s in range(5)]
        prot_ca = np.concatenate(
            [_helix(n_h, np.array([-30.0, 8.5, 1.0]), np.array([1.0, 0.05, 0.0]), rng),
             _helix(plen - 40 - n_h, np.array([30.0, -8.5, 1.0]), np.array([-1.0, 0.05, 0.0]),
                    rng)] + floor)[:plen]
        prot_rot = _frames(prot_ca, rng)
        d = np.linalg.norm(prot_ca[:, None] - pep_ca[None], axis=-1).min(1)
        order = np.argsort(d)
        n_pocket = int(np.clip((d < 12.0).sum(), 20, POCKET_MAX))
        pocket = np.sort(order[:n_pocket])
        aa = rng.choice(20, size=L, p=_AA_FREQ)
        paa = rng.choice(20, size=plen, p=_AA_FREQ)
        angles = rng.uniform(-np.pi, np.pi, size=(L, 7))
        # protein atoms: backbone group from the literature, side chains near CB
        lit = np.einsum("lij,lsj->lsi", prot_rot, ATOM14_POSITIONS[paa]) + prot_ca[:, None]
        anchor = np.where((ATOM14_MASK[paa, 4] > 0.5)[:, None], lit[:, 4], lit[:, 1])
        side = anchor[:, None] + rng.normal(size=(plen, 14, 3)) * 0.9 + np.array([0, 0, 1.2])
        pos = np.where(lit_backbone[paa][..., None], lit, side) * (ATOM14_MASK[paa] > 0.5)[..., None]
        exists = (ATOM14_MASK[paa] > 0.5) & (rng.uniform(size=(plen, 14)) > 0.03)
        exists[:, :4] = ATOM14_MASK[paa, :4] > 0.5

        out["mask"][i, :L] = True
        out["frames"][i, :L] = np.concatenate((_quats(pep_rot), pep_ca), -1)
        out["features"][i, np.arange(L), aa] = 1.0
        out["aatype"][i, :L] = aa
        tmask = chi[aa].astype(bool)
        tmask[:, :3] = False
        tmask[L - 1, 2] = True
        out["torsions_mask"][i, :L] = tmask
        out["torsions"][i, :L][tmask] = np.stack((np.sin(angles), np.cos(angles)), -1)[tmask]
        out["pocket_aatype"][i, :n_pocket] = paa[pocket]
        out["pocket_features"][i, np.arange(n_pocket), paa[pocket]] = 1.0
        out["pocket_mask"][i, :n_pocket] = True
        out["pocket_frames"][i, :n_pocket] = np.concatenate(
            (_quats(prot_rot[pocket]), prot_ca[pocket]), -1)
        out["pocket_atom14_positions"][i, :n_pocket] = pos[pocket]
        out["pocket_atom14_exists"][i, :n_pocket] = exists[pocket]
        out["protein_aatype"][i, :plen] = paa
        out["protein_atom14_positions"][i, :plen] = pos
        out["protein_atom14_exists"][i, :plen] = exists
        out["protein_len"][i] = plen
    return out


REQUEST_KEYS = ("mask", "frames", "features", "aatype", "torsions", "torsions_mask",
                "pocket_features", "pocket_mask", "pocket_frames")


def request_entry(pool: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    """Complex ``i`` as one serving request: its peptide and pocket arrays and
    its protein cut to its own length."""
    plen = int(pool["protein_len"][i])
    e = {k: pool[k][i] for k in REQUEST_KEYS}
    for k in ("protein_aatype", "protein_atom14_positions", "protein_atom14_exists"):
        e[k] = pool[k][i, :plen]
    return e
