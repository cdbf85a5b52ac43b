"""Build the port's CUDA kernels for the CPU, for the tests.

``build_emulated(name)`` compiles ``csrc/<name>.cu`` with g++ against the
runtime emulation in ``csrc/emu/`` (one std::thread per CUDA thread,
barriers for ``__syncthreads`` and the warp shuffles) into
``csrc/build/`` and loads it with ctypes. The library has the same C
interface as the nvcc build, so the wrappers' launch functions run it on
CPU tensors: the kernels' own indexing, barriers and arithmetic, checked
against their plain versions without a card. It says nothing about the
card's compiler, timing or races; ``chip_smoke.py`` does. Never used on
the main path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from pmhc_tpu_torch.ops._build import BUILD_DIR, CSRC

EMU_DIR = os.path.join(CSRC, "emu")
GXX_FLAGS = ["-std=c++20", "-O1", "-pthread", "-shared", "-fPIC"]
SMEM_FLOATS = 40960  # the largest kernel's dynamic shared memory, in floats

_TU = """#include "cuda_runtime.h"
#include "{name}.cu"
namespace pmhc {{
namespace {{
alignas(16) float smem[{n}];
struct Register {{
  Register() {{ emu_smem_ptr = smem; emu_smem_floats = {n}; }}
}} register_smem;
}}  // namespace
}}  // namespace pmhc
"""


def gxx_path() -> str | None:
    return shutil.which("g++")


def build_emulated(name: str) -> ctypes.CDLL:
    """Compile (unless built) and load ``csrc/<name>.cu`` for the CPU."""
    gxx = gxx_path()
    if gxx is None:
        raise RuntimeError("g++ not found: the kernel emulation needs a C++20 compiler")
    tu = _TU.format(name=name, n=SMEM_FLOATS)
    h = hashlib.sha256((tu + " ".join(GXX_FLAGS)).encode())
    for d in (CSRC, EMU_DIR):
        for f in sorted(os.listdir(d)):
            if f.endswith((".cu", ".cuh", ".h")):
                with open(os.path.join(d, f), "rb") as src:
                    h.update(f.encode() + b"\0" + src.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-emu-{h.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tu_path = f"{out}.{os.getpid()}.cpp"
        with open(tu_path, "w") as f:
            f.write(tu)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([gxx, *GXX_FLAGS, "-I", EMU_DIR, "-I", CSRC, "-o", tmp, tu_path],
                                  capture_output=True, text=True)
        finally:
            os.remove(tu_path)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)
