"""Residue constants: idealized amino-acid geometry tables.

The port's own copy of the committed data files of the JAX package
(``residue_tables.npz`` + ``residue_names.json``, the public AlphaFold
literature values), loaded as plain numpy arrays.

Exported tables:
- ``restype_rigid_group_default_frame``  f32[21, 8, 4, 4]
- ``restype_atom14_to_rigid_group``      i32[21, 14]
- ``restype_atom14_mask``                f32[21, 14]
- ``restype_atom14_rigid_group_positions`` f32[21, 14, 3]
- ``restypes`` (21 one-letter codes incl. X), ``restype_1to3``,
  ``restype_name_to_atom14_names``, ``rigid_group_atom_positions``
"""

import json
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

_tables = np.load(os.path.join(_DATA_DIR, "residue_tables.npz"))
restype_rigid_group_default_frame = _tables["restype_rigid_group_default_frame"]
restype_atom14_to_rigid_group = _tables["restype_atom14_to_rigid_group"]
restype_atom14_mask = _tables["restype_atom14_mask"]
restype_atom14_rigid_group_positions = _tables["restype_atom14_rigid_group_positions"]

with open(os.path.join(_DATA_DIR, "residue_names.json")) as _f:
    _names = json.load(_f)

restypes = _names["restypes"]
restype_1to3 = _names["restype_1to3"]
restype_name_to_atom14_names = _names["restype_name_to_atom14_names"]
# resname -> [(atom_name, rigid_group_idx, (x, y, z)), ...]
rigid_group_atom_positions = {
    res: [(a, g, tuple(p)) for a, g, p in entries]
    for res, entries in _names["rigid_group_atom_positions"].items()
}

__all__ = [
    "restype_rigid_group_default_frame",
    "restype_atom14_to_rigid_group",
    "restype_atom14_mask",
    "restype_atom14_rigid_group_positions",
    "restypes",
    "restype_1to3",
    "restype_name_to_atom14_names",
    "rigid_group_atom_positions",
]
