#!/usr/bin/env python3
"""Time two builds of kernel #3 (``pmhc_tpu_torch/csrc/egnn_pallas.cu``) on
one card, in turns, and the current source with one phase removed at a time.

    python3 chip_ab.py OLD.cu [--ablate]

``OLD.cu`` is an earlier version of the source, e.g. the parent commit's:

    git show HEAD~1:pmhc_tpu_torch/csrc/egnn_pallas.cu > .chip_scratch/egnn_pallas_old.cu

Both are built with ``ops/_build.NVCC_FLAGS`` (one nvcc each, in parallel)
into ``.chip_scratch/build/``, bound with ``ops/egnn_pallas.bind`` and
checked against ``egnn_pallas_plain`` at ``chip_smoke.PALLAS_TOL`` on
``chip_smoke.pallas_case``'s batch-64 inputs for both layer shapes. Then
each layer shape is timed with ``chip_smoke.time_ms`` (CUDA events) in
the order old, new, new, old, ``ITERS`` launches each. ``--ablate`` also
builds copies of the current source with one phase removed (textual
edits, ``ABLATIONS``; their outputs are wrong, they are timed only) and
times each beside the current source. One JSON line per measurement, the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".chip_scratch", "build")
ITERS = 200

# name -> (text in egnn_pallas.cu, its replacement): each removes one phase
ABLATIONS = {
    "no_heads": ("      if (jb < NP) {\n        if (hd == 0) head_task<0>",
                 "      if (jb < 0) {\n        if (hd == 0) head_task<0>"),
    "no_message": ("prod4x4(sm + S::HID, sm + S::MW2, T,", "prod4x4(sm + S::HID, sm + S::MW2, 0,"),
    "no_neighbour_projection": ("prod4x4(sm + S::HID, sm + S::MSG, HP,", "prod4x4(sm + S::HID, sm + S::MSG, 0,"),
    "no_softmax": ("    if (warp < 3) {\n      float mx", "    if (warp < 0) {\n      float mx"),
    "no_build": ("for (int it = 0; it < MAXNP * T / 4 / THREADS; ++it) {",
                 "for (int it = 0; it < 0; ++it) {"),
    "no_prefetch": ("if (row + 1 < row_hi) prefetch(row + 1);", ""),
    "no_node_terms": ("    if (r == 0) {\n      const float* nr", "    if (r < 0) {\n      const float* nr"),
    "no_feature_out": ("    if (r + 1 < rg) continue;", "    continue;"),
    "no_weight_staging": ("for (int e = tid; e < M * HEADS; e += THREADS) {",
                          "for (int e = tid; e < 0; e += THREADS) {"),
    "no_feature_hidden": ("    } else if (r + 1 == rg && warp >= 4) {", "    } else if (r < 0) {"),
    # not a phase: the heads' message-tile loads hoisted out of their k-loop
    # (every FFMA stays), to see whether shared-memory loads bound the heads
    "heads_x_hoisted": ("x[q] = ld4(hrow + 4 * q * LD + k0);", "x[q] = ld4(hrow + 4 * q * LD);"),
}


def build(name: str, source: str) -> str:
    """nvcc ``source`` (text) into ``.chip_scratch/build/lib<name>.so``."""
    from pmhc_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    out = os.path.join(OUT, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-I", _build.CSRC, "-o", out, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(json.dumps({"build": name, "ptxas": regs}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="an earlier egnn_pallas.cu")
    ap.add_argument("--ablate", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    import ctypes

    import torch

    from chip_smoke import PALLAS_TOL, card_line, pallas_case, random_model, time_ms
    from pmhc_tpu_torch.ops import _build
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    with open(os.path.join(_build.CSRC, "egnn_pallas.cu")) as f:
        new_src = f.read()
    with open(opts.old) as f:
        sources = {"old": f.read(), "new": new_src}
    if opts.ablate:
        for name, (find, repl) in ABLATIONS.items():
            if new_src.count(find) != 1:
                raise AssertionError(f"ablation {name}: its text is not in the source exactly once")
            sources[name] = new_src.replace(find, repl)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda kv: build(*kv), sources.items())))
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    libs = {k: ep.bind(ctypes.CDLL(p)) for k, p in paths.items()}

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = random_model(seed=0).to(dev).eval()
    stream = torch.cuda.current_stream().cuda_stream
    for i, layer in enumerate(("gnn1", "gnn2")):
        ctx, step = pallas_case(model, layer, seed=20 + i, device=dev)
        args = ctx.inputs(*step)
        want = ep.egnn_pallas_plain(*args)
        for k in ("old", "new"):
            got = ep.launch(libs[k], *args, stream=stream)
            torch.cuda.synchronize()
            errs = {n: float((g - w).abs().max()) for n, g, w in zip(("q", "t", "tors", "feat"), got, want)}
            ok = all(errs[n] <= PALLAS_TOL[n] for n in errs)
            print(json.dumps({"check": k, "layer": layer, "max_abs_err": errs, "ok": ok}), flush=True)
            if not ok:
                raise AssertionError(f"{k} kernel disagrees with the plain version on {layer}")
        run = lambda k: time_ms(lambda: ep.launch(libs[k], *args, stream=stream), ITERS)
        turns = [(k, run(k)) for k in ("old", "new", "new", "old")]
        print(json.dumps({"metric": "egnn_pallas_ab_ms", "layer": layer, "turns": turns,
                          "iters": ITERS, "card": card}), flush=True)
        for name in (k for k in libs if k not in ("old", "new")):
            print(json.dumps({"metric": "egnn_pallas_ablation_ms", "layer": layer, "ablation": name,
                              "ms": run(name), "new_ms": run("new"), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
