"""ctypes binding of the native SwiftMHC HDF5 decoder
(``pmhc_tpu_torch/csrc/hdf5_decoder.cc``, a copy of the JAX package's).

Counterpart of ``pmhc_tpu/data/native.py``: ``decode_packed`` decodes a
whole file's entries in one call into the stacked padded arrays of
``PackedDataset``, bit for bit what ``PmhcDataset.get_entry`` gives (same
padding, torsion-mask policy and float64 rotation-to-quaternion with
w >= 0). The decoder declares the HDF5 C API itself and opens the libhdf5
that h5py carries, so it needs no HDF5 headers and always matches the
library that wrote the files.

``is_available()`` is False only where no libhdf5 is found (no h5py: the
card's machine, which reads packed ``.npz`` files). Where it is found, the
library is built by g++ at first use (``ops/_build.py``'s host route), and
a failed build or a failed start of the decoder raises. h5py is imported
only inside the functions here.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from pmhc_tpu_torch.data.dataset import PEPTIDE_MAXLEN, POCKET_MAXLEN

_lock = threading.Lock()
_started: Dict[str, ctypes.CDLL] = {}  # libhdf5 path -> the decoder started on it


def _find_libhdf5() -> Optional[str]:
    """The libhdf5 that h5py carries or has loaded, or None without h5py."""
    try:
        import h5py
    except ImportError:
        return None
    pkg = os.path.dirname(os.path.abspath(h5py.__file__))
    # wheels carry the library beside the package (h5py.libs) or inside it (.libs)
    for base in (os.path.join(os.path.dirname(pkg), "h5py.libs"), os.path.join(pkg, ".libs")):
        if os.path.isdir(base):
            for f in sorted(os.listdir(base)):
                if f.startswith("libhdf5-") or f == "libhdf5.so":
                    return os.path.join(base, f)
    # else the one h5py has mapped into this process
    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libhdf5" in line and "_hl" not in line:
                return line.split()[-1]
    return None


def _lib() -> Optional[ctypes.CDLL]:
    """The decoder, built and started on h5py's libhdf5; None without one."""
    hdf5 = _find_libhdf5()
    if hdf5 is None:
        return None
    with _lock:
        lib = _started.get(hdf5)
        if lib is not None:
            return lib
        from pmhc_tpu_torch.ops import _build

        lib = _build.load("hdf5_decoder")
        lib.pmhc_init.argtypes = [ctypes.c_char_p]
        lib.pmhc_init.restype = ctypes.c_int
        lib.pmhc_last_error.restype = ctypes.c_char_p
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.pmhc_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    u8, f32, f32, i32, f32, u8, i32, f32, u8, f32, f32, u8]
        lib.pmhc_decode.restype = ctypes.c_int
        if lib.pmhc_init(hdf5.encode()) != 0:
            raise RuntimeError(f"native HDF5 decoder: cannot start on {hdf5}: "
                               f"{lib.pmhc_last_error().decode()}")
        _started[hdf5] = lib
        return lib


def is_available() -> bool:
    """True where a libhdf5 is found (and the decoder then built and
    started); False only where none is."""
    return _lib() is not None


def decode_packed(hdf5_path: str, names: List[str]) -> Dict[str, np.ndarray]:
    """Decode ``names`` of ``hdf5_path`` into the twelve stacked padded
    arrays of ``PackedDataset``, in one native call. Raises RuntimeError on
    a decode failure, ImportError where no libhdf5 is found."""
    lib = _lib()
    if lib is None:
        raise ImportError("native HDF5 decoder: no libhdf5 (h5py) on this machine")
    B = len(names)
    N, P, NT, OH = PEPTIDE_MAXLEN, POCKET_MAXLEN, 7, 22
    out = {
        "mask": np.empty((B, N), np.uint8),
        "frames": np.empty((B, N, 7), np.float32),
        "features": np.empty((B, N, OH), np.float32),
        "aatype": np.empty((B, N), np.int32),
        "torsions": np.empty((B, N, NT, 2), np.float32),
        "torsions_mask": np.empty((B, N, NT), np.uint8),
        "pocket_aatype": np.empty((B, P), np.int32),
        "pocket_features": np.empty((B, P, OH), np.float32),
        "pocket_mask": np.empty((B, P), np.uint8),
        "pocket_frames": np.empty((B, P, 7), np.float32),
        "pocket_atom14_positions": np.empty((B, P, 14, 3), np.float32),
        "pocket_atom14_exists": np.empty((B, P, 14), np.uint8),
    }
    c_names = (ctypes.c_char_p * B)(*[n.encode() for n in names])
    with _lock:  # the decoder keeps its last error in one global
        rc = lib.pmhc_decode(
            hdf5_path.encode(), c_names, B,
            out["mask"], out["frames"], out["features"], out["aatype"],
            out["torsions"], out["torsions_mask"], out["pocket_aatype"],
            out["pocket_features"], out["pocket_mask"], out["pocket_frames"],
            out["pocket_atom14_positions"], out["pocket_atom14_exists"])
        err = lib.pmhc_last_error().decode() if rc != 0 else ""
    if rc != 0:
        raise RuntimeError(f"native HDF5 decode of {hdf5_path} failed (rc={rc}): {err}")
    for k in ("mask", "torsions_mask", "pocket_mask", "pocket_atom14_exists"):
        out[k] = out[k].astype(bool)  # the Python decoder's bool masks
    return out
