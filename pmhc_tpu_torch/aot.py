"""Ahead-of-time sampler artifacts: a service's kernel libraries and weights
in one file, loaded by a fresh process without building anything.

Counterpart of ``pmhc_tpu/aot.py``, with its names. A serving process should
not pay the kernels' build, and a fleet should ship one reviewed program
that cannot drift from the source it was built from and that fails at
load, not mid-request, where it does not fit. ``torch.export`` cannot trace
the ctypes-bound kernels, so the port's program is the built libraries plus
the weights. Two formats, one loader (``load_sampler`` reads the magic):

- ``executable`` (``MAGIC_XC``, the default), the JAX compiled-executable
  format's counterpart: the built ``.so`` of every library the service
  runs (``LIBRARIES``: the backend's CUDA kernels, for ``fused`` the
  layer's and the sampler step's, and the PDB formatter of ``finalize``),
  the weights as the 48 reference-named arrays
  (``np.savez``, no pickle) and a JSON header. Pinned to the exporting
  process's torch and CUDA versions, platform and device name: a load
  elsewhere raises ``ValueError`` (``cannot load under``). Loading runs no
  compiler.
- ``stablehlo`` (``MAGIC``) keeps the JAX name, so ``serve_cli --aot``
  means what it means there; in the port it is the portable format: the
  libraries' sources and headers in place of the ``.so`` files, built by
  the loader with nvcc and g++ (as JAX's loader recompiles; a library
  already built from the same sources is reused). Another torch version,
  CUDA version or device only logs a warning.

Both formats are pinned to the running package's sources: the package's
wrappers declare the kernels' C arguments and pack their weights, so a
library whose digest differs from the one this package's sources give is
refused at load (``cannot load under``), before anything is installed.

The header holds JAX's ``_service_meta`` keys (``backend``, ``batch_size``,
``noise_step_count``, ``num_steps``, ``precision``) with ``torch_version``,
``cuda_version``, ``platform`` (``cuda`` or ``cpu``) and ``device_name`` in
place of ``jax_version``, each library's file, digest (the hash of its
sources, ``ops/_build.py``) and sha256, and the weights' sha256. With a
``service`` given, a configuration mismatch raises ``ValueError`` naming the
keys; a file that is not an artifact raises ``not a pmhc AOT artifact``.

The artifact is the program: after loading, the service runs the
artifact's libraries (installed under their names for the whole process:
``_build.install``, one version of a kernel per process) and the
artifact's weights, as JAX's executable bakes in the exporting process's
params. CUDA graphs cannot be serialised, so a loaded service still
captures its chain once per shape at its first request (the header says
so). On the CPU the service launches no CUDA library: an artifact of a CPU
service carries the host libraries and whatever is loaded in the process
under the kernels' names.

File layout: the 8-byte magic, the header's length (u32 little-endian),
the header (JSON), then the blobs the header lists, in its order.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import struct
import tempfile
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

_log = logging.getLogger(__name__)

MAGIC = b"PMHCAOT1"     # portable: the libraries' sources, built at load
MAGIC_XC = b"PMHCAOTX"  # executable: the built libraries
# the libraries a service runs: its backend's CUDA kernel, and the PDB
# formatter of finalize (host code)
LIBRARIES = {"fused": ("egnn_fused", "sampler_step", "pdb_formatter"), "pallas": ("egnn_pallas", "pdb_formatter"),
             "dense": ("pdb_formatter",), "blockwise": ("pdb_formatter",)}
CONFIG_KEYS = ("backend", "batch_size", "noise_step_count", "num_steps", "precision")
PINNED_KEYS = ("torch_version", "cuda_version", "device_name")
GRAPHS_NOTE = ("CUDA graphs are not serialised: a loaded service captures its chain once per "
               "shape at its first request")


def _platform(device) -> Dict[str, Any]:
    dev = torch.device(device)
    return {"torch_version": torch.__version__, "cuda_version": torch.version.cuda,
            "platform": dev.type,
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def _service_meta(service) -> Dict[str, Any]:
    return {**_platform(service.device),
            "backend": service.backend,
            "batch_size": service.batch_size,
            "noise_step_count": service.diffusion_config.noise_step_count,
            "num_steps": service.num_steps,
            "precision": service.precision,
            "seed": service.seed,
            "graphs": GRAPHS_NOTE}


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def weights_sha256(state_dict) -> str:
    """The sha256 of a state dict's arrays (names, dtypes, shapes, bytes),
    whatever device they lie on."""
    h = hashlib.sha256()
    for name in sorted(state_dict):
        a = np.ascontiguousarray(torch.as_tensor(state_dict[name]).detach().cpu().numpy())
        h.update(f"{name}\0{a.dtype.str}\0{a.shape}\0".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _weights_npz(model) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
    return buf.getvalue()


def _pack(magic: bytes, meta: Dict[str, Any], blobs: List[Tuple[str, bytes]]) -> bytes:
    meta = dict(meta, blobs=[[key, len(data)] for key, data in blobs])
    head = json.dumps(meta).encode()
    return b"".join([magic, struct.pack("<I", len(head)), head] + [data for _, data in blobs])


def _runs_on(name: str, platform: str) -> bool:
    """Whether library ``name`` runs on ``platform``: host code anywhere,
    a CUDA kernel on the card."""
    from pmhc_tpu_torch.ops import _build

    return platform == "cuda" or _build.source_files(name)[0].endswith(".cc")


def _service_libraries(service) -> List[Tuple[str, Any]]:
    """(name, ``_build.Loaded``) of the service's libraries loaded in this
    process; those its platform runs are loaded (built) here if not yet."""
    from pmhc_tpu_torch.ops import _build

    out = []
    for name in LIBRARIES[service.backend]:
        if _runs_on(name, service.device.type):
            _build.load(name)
        have = _build.loaded(name)
        if have is not None:
            out.append((name, have))
    return out


def export_compiled(service) -> bytes:
    """The ``executable`` artifact of ``service``: its built libraries,
    weights and header (no compiler at load)."""
    weights = _weights_npz(service.model)
    blobs = [("weights.npz", weights)]
    libraries = []
    for name, have in _service_libraries(service):
        with open(have.path, "rb") as f:
            data = f.read()
        file = os.path.basename(have.path)
        libraries.append({"name": name, "file": file, "digest": have.digest,
                          "sha256": _sha256(data)})
        blobs.append(("lib/" + file, data))
    meta = dict(_service_meta(service), libraries=libraries,
                weights_sha256=weights_sha256(service.model.state_dict()))
    return _pack(MAGIC_XC, meta, blobs)


def export_sampler(service) -> bytes:
    """The portable (``stablehlo``) artifact of ``service``: its libraries'
    sources and headers, weights and header (the loader builds)."""
    from pmhc_tpu_torch.ops import _build

    blobs = [("weights.npz", _weights_npz(service.model))]
    sources = []
    for name in LIBRARIES[service.backend]:
        files = _build.source_files(name)
        sources.append({"name": name, "digest": _build.digest(name), "files": files})
        for f in files:
            with open(os.path.join(_build.CSRC, f), "rb") as src:
                blobs.append((f"src/{name}/{f}", src.read()))
    meta = dict(_service_meta(service), sources=sources,
                weights_sha256=weights_sha256(service.model.state_dict()))
    return _pack(MAGIC, meta, blobs)


def save_sampler(service, path: str, fmt: str = "executable") -> None:
    """Write an artifact: ``fmt="executable"`` (default: loads with no
    compiler) or ``fmt="stablehlo"`` (portable: the loader builds)."""
    if fmt not in ("executable", "stablehlo"):
        raise ValueError(f"unknown AOT format {fmt!r}")
    data = export_compiled(service) if fmt == "executable" else export_sampler(service)
    with open(path, "wb") as f:
        f.write(data)
    _log.info("exported AOT sampler artifact (%s, %d bytes) to %s", fmt, len(data), path)


def read_artifact(path: str) -> Tuple[bytes, Dict[str, Any], Dict[str, bytes]]:
    """``(magic, header, blobs by key)`` of an artifact file."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:len(MAGIC)]
    if magic not in (MAGIC, MAGIC_XC) or len(data) < len(MAGIC) + 4:
        raise ValueError(f"{path}: not a pmhc AOT artifact")
    off = len(MAGIC)
    (meta_len,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        meta = json.loads(data[off:off + meta_len].decode())
        blobs = {}
        off += meta_len
        for key, n in meta["blobs"]:
            blobs[key] = data[off:off + n]
            off += n
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{path}: damaged pmhc AOT artifact ({e})") from None
    if off != len(data):
        raise ValueError(f"{path}: damaged pmhc AOT artifact ({len(data) - off} bytes unaccounted)")
    return magic, meta, blobs


def _write_library(file: str, data: bytes) -> str:
    """The artifact's library as a file in ``BUILD_DIR`` (its name carries
    its digest), written unless the same bytes are there."""
    from pmhc_tpu_torch.ops import _build

    path = os.path.join(_build.BUILD_DIR, file)
    if os.path.exists(path):
        with open(path, "rb") as f:
            if _sha256(f.read()) == _sha256(data):
                return path
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def _refuse_other_sources(path: str, name: str, carried: str) -> None:
    """Raise unless library ``name`` of the artifact (digest ``carried``)
    was built from this package's sources: the package's wrappers declare
    the kernels' arguments and pack their weights, so a library of other
    sources would be launched with a layout it was not built for."""
    from pmhc_tpu_torch.ops import _build

    here = _build.digest(name)
    if carried != here:
        raise ValueError(f"{path}: library {name!r} built from sources of digest {carried} "
                         f"cannot load under this package, whose sources give {here}; "
                         f"re-export the artifact with this package")


def _install_libraries(path: str, magic: bytes, meta: Dict[str, Any], blobs: Dict[str, bytes]):
    from pmhc_tpu_torch.ops import _build

    platform = meta["platform"]
    if magic == MAGIC_XC:
        carried = {lib["name"] for lib in meta["libraries"]}
        missing = [n for n in LIBRARIES[meta["backend"]]
                   if n not in carried and _runs_on(n, platform)]
        if missing:
            raise ValueError(f"{path}: damaged pmhc AOT artifact (no library {missing})")
        for lib in meta["libraries"]:
            data = blobs["lib/" + lib["file"]]
            if _sha256(data) != lib["sha256"] or lib["file"] != f"lib{lib['name']}-{lib['digest']}.so":
                raise ValueError(f"{path}: damaged pmhc AOT artifact (library {lib['file']})")
            _refuse_other_sources(path, lib["name"], lib["digest"])
        for lib in meta["libraries"]:
            _build.install(lib["name"], _write_library(lib["file"], blobs["lib/" + lib["file"]]))
        return
    with tempfile.TemporaryDirectory() as tmp:
        for src in meta["sources"]:
            os.makedirs(os.path.join(tmp, src["name"]))
            for f in src["files"]:
                with open(os.path.join(tmp, src["name"], f), "wb") as out:
                    out.write(blobs[f"src/{src['name']}/{f}"])
            if _build.digest(src["name"], os.path.join(tmp, src["name"])) != src["digest"]:
                raise ValueError(f"{path}: damaged pmhc AOT artifact (sources of {src['name']})")
            _refuse_other_sources(path, src["name"], src["digest"])
        for src in meta["sources"]:
            if _runs_on(src["name"], platform):
                built = _build.build(src["name"], src_dir=os.path.join(tmp, src["name"]))
                _build.install(src["name"], built["path"])


def load_sampler(path: str, service=None) -> Callable:
    """Load an artifact; returns the ``(model_batch, generator) -> state``
    callable (``SamplerService.sample_model_batch``) that samples with it.

    With ``service`` given, its configuration is checked against the
    artifact's, and the service then runs the artifact's libraries and
    weights (a warning is logged when its own weights differ). Without, the
    callable is that of a service built from the header's configuration and
    the artifact's weights, on the header's platform.
    """
    from pmhc_tpu_torch.serve import SamplerService

    magic, meta, blobs = read_artifact(path)
    if service is not None:
        device = service.device
    else:
        device = torch.device("cuda" if meta["platform"] == "cuda" and torch.cuda.is_available()
                              else "cpu")
    here = _platform(device)
    if meta["platform"] != here["platform"]:
        raise ValueError(f"{path}: artifact was built for platform '{meta['platform']}' but this "
                         f"process runs '{here['platform']}'")
    drift = {k: (meta[k], here[k]) for k in PINNED_KEYS if meta[k] != here[k]}
    if drift:
        if magic == MAGIC_XC:
            raise ValueError(
                f"{path}: executable artifact built under "
                f"{ {k: v[0] for k, v in drift.items()} } cannot load under "
                f"{ {k: v[1] for k, v in drift.items()} }; re-export, or use the stablehlo "
                f"format, which builds its libraries at load")
        _log.warning("%s: artifact built under %s, running %s: its libraries are built here",
                     path, {k: v[0] for k, v in drift.items()}, {k: v[1] for k, v in drift.items()})
    if service is not None:
        mine = _service_meta(service)
        mismatch = {k: (meta[k], mine[k]) for k in CONFIG_KEYS if meta[k] != mine[k]}
        if mismatch:
            raise ValueError(f"{path}: artifact configuration does not match the service: "
                             f"{mismatch}")
    with np.load(io.BytesIO(blobs["weights.npz"]), allow_pickle=False) as z:
        weights = {k: torch.from_numpy(z[k]) for k in z.files}
    if weights_sha256(weights) != meta["weights_sha256"]:
        raise ValueError(f"{path}: damaged pmhc AOT artifact (weights)")
    _install_libraries(path, magic, meta, blobs)
    if service is None:
        service = SamplerService(weights, batch_size=meta["batch_size"],
                                 noise_step_count=meta["noise_step_count"],
                                 num_steps=meta["num_steps"], backend=meta["backend"],
                                 bf16=meta["precision"] == "bf16",
                                 fast_f32=meta["precision"] == "fast-f32", seed=meta["seed"],
                                 device=device)
    else:
        if weights_sha256(service.model.state_dict()) != meta["weights_sha256"]:
            _log.warning("%s: the service's weights differ from the artifact's (sha256 %s); "
                         "the artifact's weights run", path, meta["weights_sha256"][:12])
        service.model.load_state_dict(weights, strict=True)
    return service.sample_model_batch
