"""ctypes binding of the native PDB ATOM-record formatter
(``pmhc_tpu_torch/csrc/pdb_formatter.cc``, a copy of the JAX package's).

Counterpart of ``pmhc_tpu/io/pdb_native.py``: ``format_atoms`` writes all
ATOM records of one chain from packed field arrays with ``snprintf``, byte
for byte what ``io/pdb.py``'s Python formatter writes. The library is built
by g++ at first use (``ops/_build.py``'s host route). Unlike the JAX
package, a failed build raises with g++'s output instead of falling back to
Python: this is the serving path. ``io/pdb.py`` takes the Python formatter
only when ``PMHC_PDB_FORMATTER=python`` asks for it.

``CALLS`` counts the calls that formatted through the library, as the
kernel wrappers count their launches.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LINE = 81  # a record's length while the serial and coordinates fit their widths
# the widest record: serial and residue number as 11-digit ints, each
# coordinate as the longest %8.3f of a double (309 digits, a sign, ".ddd")
_WIDEST = 81 + 2 * 7 + 3 * (309 + 5 - 8)

CALLS = {"format_atoms": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _lib() -> ctypes.CDLL:
    from pmhc_tpu_torch.ops import _build

    lib = _build.load("pdb_formatter")
    if not getattr(lib, "_pmhc_typed", False):
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.pmhc_format_atoms.argtypes = [ctypes.c_int, i32, i32, ctypes.c_char, u8, u8, u8, f64,
                                          u8, ctypes.c_long]
        lib.pmhc_format_atoms.restype = ctypes.c_long
        lib._pmhc_typed = True
    return lib


def is_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _lib() is not None


def format_atoms(serials: np.ndarray, resseqs: np.ndarray, chain: str, names4: np.ndarray,
                 resnames3: np.ndarray, elements2: np.ndarray, xyz: np.ndarray) -> bytes:
    """All ATOM records of one chain as bytes. Arrays: ``serials`` and
    ``resseqs`` int32 [n], ``names4`` uint8 [n, 4] (the padded name field),
    ``resnames3`` uint8 [n, 3], ``elements2`` uint8 [n, 2] (right-justified),
    ``xyz`` float64 [n, 3]."""
    n = int(serials.shape[0])
    for name, a, shape in (("resseqs", resseqs, (n,)), ("names4", names4, (n, 4)),
                           ("resnames3", resnames3, (n, 3)), ("elements2", elements2, (n, 2)),
                           ("xyz", xyz, (n, 3))):
        if tuple(a.shape) != shape:
            raise ValueError(f"format_atoms: {name} has shape {a.shape}, expected {shape}")
    if len(chain) != 1:
        raise ValueError(f"format_atoms: chain {chain!r} is not one character")
    if n == 0:
        return b""
    lib = _lib()
    args = (n, np.ascontiguousarray(serials, np.int32), np.ascontiguousarray(resseqs, np.int32),
            chain.encode(), np.ascontiguousarray(names4, np.uint8),
            np.ascontiguousarray(resnames3, np.uint8), np.ascontiguousarray(elements2, np.uint8),
            np.ascontiguousarray(xyz, np.float64))
    # a numpy buffer, not ctypes.create_string_buffer: that makes a new
    # (c_char * cap) type per call (~1 ms). Fixed-width records fit the
    # first buffer; wider ones (huge coordinates) the second
    for cap in (n * _LINE + 4096, n * _WIDEST + 4096):
        out = np.empty(cap, np.uint8)
        written = lib.pmhc_format_atoms(*args, out, cap)
        if written >= 0:
            CALLS["format_atoms"] += 1
            return out[:written].tobytes()
    raise RuntimeError(f"format_atoms: {n} records overflowed {cap} bytes")
