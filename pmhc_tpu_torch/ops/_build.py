"""Build and load the port's native libraries (compiler -> shared library -> ctypes).

Two routes, by the source's suffix:

- ``csrc/<name>.cu``, a CUDA kernel, compiled with

      nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

- ``csrc/<name>.cc``, host code (the PDB formatter, the HDF5 decoder),
  compiled with ``g++ -O2 -shared -fPIC`` (linked with ``-ldl``).

Either is built at first use into ``pmhc_tpu_torch/csrc/build/`` (listed in
``.gitignore``). The library's file name carries its digest, a hash of the
flags, of its source and, for a CUDA source, of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. ``install`` loads a library that is already built, from a
given path, without a compiler (the AOT loader, ``aot.py``). A process
holds one library per name: loading a second one of another digest
raises, so one process never runs two versions of a kernel. A failed build
raises with the compiler's output. Nothing here runs at import. A first
``load`` of a name is the span ``ops.build`` (its id the name); the
counter ``ops.builds`` counts the compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, NamedTuple, Optional

from pmhc_tpu_torch.utils.profiling import count, span

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
GXX_LIBS = ["-ldl"]  # after the source: the HDF5 decoder dlopens libhdf5


class Loaded(NamedTuple):
    """A library loaded in this process: its digest, file and handle."""

    digest: str
    path: str
    lib: ctypes.CDLL


_LIBS: dict = {}  # name -> Loaded
_lock = threading.Lock()


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's native libraries need a C++ compiler on PATH")
    return found


def source_files(name: str, src_dir: str = CSRC) -> List[str]:
    """The files library ``name`` is built from, relative to ``src_dir``:
    ``<name>.cc``, or ``<name>.cu`` and every ``.cuh`` header beside it."""
    if os.path.exists(os.path.join(src_dir, name + ".cc")):
        return [name + ".cc"]
    return [name + ".cu"] + sorted(f for f in os.listdir(src_dir) if f.endswith(".cuh"))


def digest(name: str, src_dir: str = CSRC) -> str:
    """The hash a library's file name carries: of its flags and sources."""
    files = source_files(name, src_dir)
    flags = GXX_FLAGS + GXX_LIBS if files[0].endswith(".cc") else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        with open(os.path.join(src_dir, f), "rb") as src:
            h.update(f.encode() + b"\0" + src.read())
    return h.hexdigest()[:12]


def library_path(name: str, src_dir: str = CSRC) -> str:
    """The library's path in ``BUILD_DIR``: ``lib<name>-<digest>.so``."""
    return os.path.join(BUILD_DIR, f"lib{name}-{digest(name, src_dir)}.so")


def build(name: str, ptxas_verbose: bool = False, src_dir: str = CSRC) -> dict:
    """Compile ``<src_dir>/<name>.cu`` (nvcc) or ``<name>.cc`` (g++) unless
    its library is already built. Returns ``{"path", "seconds", "log"}``;
    ``log`` holds the compiler's output (``-Xptxas -v`` for a CUDA source:
    registers, shared memory, spills when asked)."""
    out = library_path(name, src_dir)
    if os.path.exists(out) and not ptxas_verbose:
        return {"path": out, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    src = os.path.join(src_dir, source_files(name, src_dir)[0])
    if src.endswith(".cc"):
        cmd = [gxx_path(), *GXX_FLAGS, "-o", tmp, src, *GXX_LIBS]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", tmp, src]
    count("ops.builds")
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({proc.returncode}) on {src}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return {"path": out, "seconds": seconds, "log": proc.stdout + proc.stderr}


def install(name: str, path: str) -> ctypes.CDLL:
    """Load the library built at ``path`` under ``name``, with no compiler.
    Its digest is the one its file name carries (``lib<name>-<digest>.so``).
    A library of the same digest already loaded under ``name`` is returned;
    one of another digest raises."""
    base = os.path.basename(path)
    prefix = f"lib{name}-"
    if not (base.startswith(prefix) and base.endswith(".so")):
        raise ValueError(f"{path}: not a library of {name!r} (lib{name}-<digest>.so)")
    dig = base[len(prefix):-len(".so")]
    with _lock:
        have = _LIBS.get(name)
        if have is not None:
            if have.digest != dig:
                raise RuntimeError(
                    f"library {name!r} of digest {have.digest} is already loaded in this "
                    f"process ({have.path}); refusing a second one of digest {dig} ({path})")
            return have.lib
        lib = ctypes.CDLL(path)
        _LIBS[name] = Loaded(dig, path, lib)
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``: the one installed, else built from
    ``csrc/`` on first use."""
    have = _LIBS.get(name)
    if have is not None:
        return have.lib
    with span("ops.build", name):
        return install(name, build(name)["path"])


def loaded(name: str) -> Optional[Loaded]:
    """The library loaded under ``name`` in this process, if any."""
    return _LIBS.get(name)
