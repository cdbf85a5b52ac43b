"""The AOT artifact on the card: a fresh process's time to its first
sampled result without the artifact and with it, and its output.

The twin of the JAX package's ``tools/bench_aot.py``. A ``SamplerService``
(the published-width network drawn from seed 0, ``--batch-size`` realistic
entries from seed 3 (``data/realistic.py``: chains P and M), the start noise and the chain's noise from a generator
seeded 7) samples one batch to its PDBs. Modes:

- ``--mode export``: sample the batch in this process, save the artifact
  (``pmhc_tpu_torch/aot.py``, ``--fmt``) and the reference outputs (the
  PDB arrays and the PDB bytes, an ``.npz``);
- ``--mode load``: in this (fresh) process, build the service, load
  ``--artifact`` if given, sample the same batch, and check that every
  array and every PDB byte equals the reference; prints
  ``first_result_s``, from before the service is built to the PDBs in hand
  (the kernels' build, where one happens, included), and the launch counts;
- ``--mode bench`` (default): export here, then one fresh process per arm
  (``--arms``), each importing a copy of ``pmhc_tpu_torch`` made in a
  temporary directory:

  - ``cold``: no artifact, the copy's ``csrc/build/`` empty: nvcc builds;
  - ``warm``: no artifact, this process's built libraries copied in;
  - ``aot``: the artifact, the build directory empty and nvcc unreachable
    (``CUDA_HOME`` an empty directory, no ``nvcc`` on ``PATH``): it must
    sample without building;
  - ``mismatch``: as ``aot``, with the artifact's ``device_name`` doctored:
    the load must refuse it (``cannot load under``) before any sampling.

    python -m pmhc_tpu_torch.tools.bench_aot [--batch-size 64] [-T 1000] [--sample-steps 100] [--backend auto] [--bf16]

One JSON line per arm, with its wall as the parent saw it
(``process_s``) and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from argparse import ArgumentParser
from typing import Any, Dict, List

import numpy as np
import torch

from pmhc_tpu_torch.tools import BACKEND_CHOICES, card_line, make_entries, random_params

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("cold", "warm", "aot", "mismatch")
REFUSED = 3  # a load mode's exit code when the artifact was refused


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("bench", "export", "load"), default="bench")
    p.add_argument("--batch-size", "-b", type=int, default=64)
    p.add_argument("-T", type=int, default=1000)
    p.add_argument("--sample-steps", type=int, default=None,
                   help="strided few-step sampling (default: full T)")
    p.add_argument("--backend", default="auto", choices=BACKEND_CHOICES + ("blockwise",))
    p.add_argument("--bf16", action="store_true", help="bf16 mode of the fused kernel")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the fused kernel (products split into bf16 halves)")
    p.add_argument("--fmt", default="executable", choices=("executable", "stablehlo"),
                   help="artifact format (aot.py): executable carries the built libraries; "
                        "stablehlo their sources, built at load")
    p.add_argument("--arms", default="cold,warm,aot", help=f"comma list of {', '.join(ARMS)}")
    p.add_argument("--artifact", default=None, help="(export, load) the artifact's path")
    p.add_argument("--expected", default=None, help="(export, load) the reference outputs (.npz)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the kernels' plain versions)")
    return p


def config_argv(args) -> List[str]:
    """The service's flags, for a child process."""
    out = ["-b", str(args.batch_size), "-T", str(args.T), "--backend", args.backend,
           "--fmt", args.fmt, "--device", args.device]
    if args.sample_steps:
        out += ["--sample-steps", str(args.sample_steps)]
    return out + ["--bf16"] * args.bf16 + ["--fast-f32"] * args.fast_f32


def build_service(args):
    from pmhc_tpu_torch.serve import SamplerService

    return SamplerService(random_params(), batch_size=args.batch_size, noise_step_count=args.T,
                          num_steps=args.sample_steps, backend=args.backend, bf16=args.bf16,
                          fast_f32=args.fast_f32, seed=0, device=args.device)


def sample_pinned(service) -> Dict[str, np.ndarray]:
    """The pinned batch through ``dispatch`` / ``finalize``: its PDB arrays
    and its PDB bytes (``pdb``, with ``pdb_lens``)."""
    from pmhc_tpu_torch.io.pdb import fetch_pdb_arrays

    entries = make_entries("realistic", service.batch_size, seed=3)
    handle = service.dispatch(entries, torch.Generator(device=service.device).manual_seed(7))
    pdbs = service.finalize(handle)
    out = fetch_pdb_arrays(handle.conv)
    out["pdb"] = np.frombuffer(b"".join(pdbs), np.uint8)
    out["pdb_lens"] = np.array([len(p) for p in pdbs], np.int64)
    return out


def launches() -> Dict[str, Any]:
    """This process's kernel launches and native PDB formatter calls."""
    from pmhc_tpu_torch.io import pdb_native
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    return {"fused": dict(ef.LAUNCHES), "pallas": dict(ep.LAUNCHES), "loop": dict(el.LAUNCHES),
            "pdb_native": dict(pdb_native.CALLS)}


def run_export(args) -> Dict[str, Any]:
    from pmhc_tpu_torch.aot import save_sampler

    service = build_service(args)
    t0 = time.perf_counter()
    out = sample_pinned(service)
    first = time.perf_counter() - t0
    save_sampler(service, args.artifact, fmt=args.fmt)
    np.savez(args.expected, **out)
    row = {"metric": "bench_aot", "arm": "export", "fmt": args.fmt, "backend": service.backend,
           "precision": service.precision, "batch_size": args.batch_size, "T": args.T,
           "sample_steps": args.sample_steps or args.T, "first_result_s": first,
           "artifact_bytes": os.path.getsize(args.artifact), "device": str(service.device),
           "card": card_line(service.device)}
    print(json.dumps(row), flush=True)
    return row


def run_load(args) -> Dict[str, Any]:
    """A fresh process's arm: the service, the artifact if given, the pinned
    batch; every output held bit for bit against ``--expected``."""
    from pmhc_tpu_torch import aot
    from pmhc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    service = build_service(args)
    row = {"metric": "bench_aot", "arm": "aot" if args.artifact else "plain",
           "backend": service.backend, "precision": service.precision,
           "batch_size": args.batch_size, "sample_steps": args.sample_steps or args.T,
           "device": str(service.device)}
    if args.artifact:
        try:
            aot.load_sampler(args.artifact, service)
        except ValueError as e:
            print(json.dumps({**row, "refused": str(e), "launches": launches()}), flush=True)
            raise SystemExit(REFUSED) from None
    out = sample_pinned(service)
    first = time.perf_counter() - t0
    with np.load(args.expected) as want:
        if sorted(want.files) != sorted(out):
            raise AssertionError(f"outputs {sorted(out)} against expected {sorted(want.files)}")
        for k in want.files:
            np.testing.assert_array_equal(out[k], want[k], err_msg=f"{k} differs from the export")
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    row.update(first_result_s=first, bit_identical=True, launches=launches(),
               libraries={n: _build.loaded(n).digest for n in aot.LIBRARIES[service.backend]
                          if _build.loaded(n) is not None},  # the CPU loads no kernel
               nvcc=nvcc)
    print(json.dumps(row), flush=True)
    return row


def doctor(src: str, dst: str, **changes) -> None:
    """Artifact ``src`` with header keys changed, written to ``dst``."""
    import struct

    from pmhc_tpu_torch.aot import read_artifact

    magic, meta, blobs = read_artifact(src)
    meta.update(changes)
    head = json.dumps(meta).encode()
    with open(dst, "wb") as f:
        f.write(magic + struct.pack("<I", len(head)) + head)
        for key, _ in meta["blobs"]:
            f.write(blobs[key])


def run_arm(arm: str, args, work: str) -> Dict[str, Any]:
    """One fresh process of ``arm`` on a copy of the package in ``work``."""
    from pmhc_tpu_torch.ops import _build

    root = tempfile.mkdtemp(prefix=f"arm_{arm}_", dir=work)
    pkg = os.path.join(root, "pmhc_tpu_torch")
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("build", "__pycache__"))
    if arm == "warm":
        shutil.copytree(_build.BUILD_DIR, os.path.join(pkg, "csrc", "build"))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "pmhc_tpu_torch.tools.bench_aot", "--mode", "load",
           "--expected", args.expected, *config_argv(args)]
    if arm in ("aot", "mismatch"):
        no_cuda = os.path.join(root, "no_cuda")
        os.makedirs(no_cuda)
        env["CUDA_HOME"] = no_cuda
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
        artifact = args.artifact
        if arm == "mismatch":
            artifact = os.path.join(root, "doctored.aot")
            doctor(args.artifact, artifact, device_name="a device this is not")
        cmd += ["--artifact", artifact]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    want_rc = REFUSED if arm == "mismatch" else 0
    if proc.returncode != want_rc or not lines:
        raise RuntimeError(f"bench_aot arm {arm}: exit {proc.returncode} (expected {want_rc})\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    row = dict(json.loads(lines[-1]), arm=arm, process_s=wall, card=card_line(args.device))
    if arm == "mismatch" and ("cannot load under" not in row["refused"]
                              or any(v for c in row["launches"].values() for v in c.values())):
        raise RuntimeError(f"bench_aot arm mismatch: not refused before sampling: {row}")
    if arm == "aot" and row["nvcc"] is not None:
        raise RuntimeError(f"bench_aot arm aot: nvcc was reachable ({row['nvcc']})")
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "export":
        return run_export(args)
    if args.mode == "load":
        return run_load(args)
    arms = args.arms.split(",")
    bad = [a for a in arms if a not in ARMS]
    if bad:
        raise SystemExit(f"bench_aot: unknown arms {bad}: use {', '.join(ARMS)}")
    from pmhc_tpu_torch.serve import resolve_device

    resolve_device(args.device)  # without a card, fail before any work
    with tempfile.TemporaryDirectory(prefix="bench_aot_") as work:
        args.artifact = os.path.join(work, "sampler.aot")
        args.expected = os.path.join(work, "expected.npz")
        rows = [run_export(args)]
        rows += [run_arm(arm, args, work) for arm in arms]
    return rows


if __name__ == "__main__":
    main()
