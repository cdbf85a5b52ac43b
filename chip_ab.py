#!/usr/bin/env python3
"""Time two builds of a kernel on one card, in turns, and the current source
with one phase removed at a time: kernel #3 (``csrc/egnn_pallas.cu``) or
the training loop's backward (``csrc/egnn_loop.cu``, TPU kernels #6/#7).

    python3 chip_ab.py OLD.cu [--kernel pallas|loop] [--ablate] [--phases]

``OLD.cu`` is an earlier version of the source, e.g. the parent commit's:

    git show HEAD~1:pmhc_tpu_torch/csrc/egnn_pallas.cu > .chip_scratch/egnn_pallas_old.cu
    git show HEAD~1:pmhc_tpu_torch/csrc/egnn_loop.cu > .chip_scratch/egnn_loop_old.cu

Both are built with ``ops/_build.NVCC_FLAGS`` (one nvcc each, in parallel)
into ``.chip_scratch/build/`` and bound with the wrapper's ``bind``. Kernel
#3: checked against ``egnn_pallas_plain`` at ``chip_smoke.PALLAS_TOL`` on
``chip_smoke.pallas_case``'s batch-64 inputs for both layer shapes, then
each layer shape timed. The loop: forward and backward of both builds
checked against the plain version and its autograd
(``chip_smoke.loop_run(..., kernel=False)``) at ``chip_smoke.LOOP_TOL`` on
``chip_smoke.loop_case``'s batch-64 inputs, both layer shapes and both
modes, then the backward timed per layer and mode. Times are
``chip_smoke.time_ms`` (CUDA events) in the order old, new, new, old,
``ITERS`` launches each. ``--ablate`` also builds copies of the current
source with one phase removed (textual edits, ``ABLATIONS``; their
outputs are wrong, they are timed only) and times each beside the
current source. ``--phases`` (loop) also builds the current source with
``-DPMHC_LOOP_PHASES`` and prints the backward's clock64 cycles per phase
(barrier to barrier) and per warp (to its arrival at the phase's closing
barrier), summed over the blocks. One JSON line per measurement, the
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

# kernel -> name -> [(text in the source, its replacement), ...]: each
# removes one phase; every text must occur in the source (all its
# occurrences are replaced)
ABLATIONS = {"pallas": {
    "no_heads": [("      if (jb < NP) {\n        if (hd == 0) head_task<0>",
                  "      if (jb < 0) {\n        if (hd == 0) head_task<0>")],
    "no_message": [("prod4x4(sm + S::HID, sm + S::MW2, T,", "prod4x4(sm + S::HID, sm + S::MW2, 0,")],
    "no_neighbour_projection": [("prod4x4(sm + S::HID, sm + S::MSG, HP,", "prod4x4(sm + S::HID, sm + S::MSG, 0,")],
    "no_softmax": [("    if (warp < 3) {\n      float mx", "    if (warp < 0) {\n      float mx")],
    "no_build": [("for (int it = 0; it < MAXNP * T / 4 / THREADS; ++it) {",
                  "for (int it = 0; it < 0; ++it) {")],
    "no_prefetch": [("if (row + 1 < row_hi) prefetch(row + 1);", "")],
    "no_node_terms": [("    if (r == 0) {\n      const float* nr", "    if (r < 0) {\n      const float* nr")],
    "no_feature_out": [("    if (r + 1 < rg) continue;", "    continue;")],
    "no_weight_staging": [("for (int e = tid; e < M * HEADS; e += THREADS) {",
                           "for (int e = tid; e < 0; e += THREADS) {")],
    "no_feature_hidden": [("    } else if (r + 1 == rg && warp >= 4) {", "    } else if (r < 0) {")],
    # not a phase: the heads' message-tile loads hoisted out of their k-loop
    # (every FFMA stays), to see whether shared-memory loads bound the heads
    "heads_x_hoisted": [("x[q] = ld4(hrow + 4 * q * LD + k0);", "x[q] = ld4(hrow + 4 * q * LD);")],
}, "loop": {
    # the three products of d(pre_heads) / hid tiles, one at a time
    "no_head_product": [("for (int k0 = 0; k0 < T; k0 += 4) {", "for (int k0 = 0; k0 < 0; k0 += 4) {"),
                        ("        mma_bf16_16816(cc[nn], a[ks], b);\n", "")],
    "no_dwhm_product": [("p3_bf16(sm, warp, lane);", ""), ("p3_fp32(sm, warp, lane);", "")],
    "no_dhid_product": [("for (int k0 = 0; k0 < HEADS; k0 += 4) {", "for (int k0 = 0; k0 < 0; k0 += 4) {"),
                        ("for (int ks = 0; ks < HEADS / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")],
    # d(a_j), d(edge) (2 per pair and column) and phase F's d(q_j), d(t_j)
    "no_atomics": [("  atomicAdd(reinterpret_cast<float4*>(io.daj + aj_at), v);\n", ""),
                   ("  atomicAdd(reinterpret_cast<float4*>(io.dedge + edge_at), v);\n", ""),
                   ("  atomicAdd(reinterpret_cast<float2*>(io.daj + aj_at), v);\n", ""),
                   ("  atomicAdd(reinterpret_cast<float2*>(io.dedge + edge_at), v);\n", ""),
                   ("atomicAdd(io.dqj + ((size_t)b * NP + j) * 4 + c, dqj[c]);", "(void)dqj[c];"),
                   ("atomicAdd(io.dtj + ((size_t)b * NP + j) * 3 + c, dtj[c]);", "(void)dtj[c];")],
    "no_phases_BF": [("if (nbr) {", "if (false) {")],
    "no_E": [("constexpr int NS = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 0;", "constexpr int NS = HEAD < 0 ? 2 : 0;")],
    "no_unit_sums": [("for (int jj = 0; jj < BT; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
    "no_build": [("for (int e = tid; e < (BT / 2) * (T / 2); e += BTHREADS) {",
                  "for (int e = tid; e < 0; e += BTHREADS) {"),
                 ("for (int e = tid; e < BT * T / 4; e += BTHREADS) {", "for (int e = tid; e < 0; e += BTHREADS) {")],
    "no_weight_staging": [("for (int e = tid; e < 4 * 8 * 4 * 32; e += BTHREADS) {",
                           "for (int e = tid; e < 0; e += BTHREADS) {"),
                          ("for (int e = tid; e < 8 * 16 * 32; e += BTHREADS) {",
                           "for (int e = tid; e < 0; e += BTHREADS) {"),
                          ("for (int e = tid; e < HEADS * T / 4; e += BTHREADS) {\n      const int u",
                           "for (int e = tid; e < 0; e += BTHREADS) {\n      const int u")],
}}


def build(name: str, source: str, flags=()) -> str:
    """nvcc ``source`` (text) into ``.chip_scratch/build/lib<name>.so``."""
    from pmhc_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    out = os.path.join(OUT, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
                           "-I", _build.CSRC, "-o", out, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(json.dumps({"build": name, "ptxas": regs}), flush=True)
    return out


def ablated(src: str, edits) -> str:
    """``src`` with each (text, replacement) of ``edits`` applied to every
    occurrence; a text that does not occur is an error."""
    for find, repl in edits:
        if find not in src:
            raise AssertionError(f"ablation text not in the source: {find!r}")
        src = src.replace(find, repl)
    return src


def pallas_ab(libs, card, dev, run_ms) -> None:
    """Kernel #3: both builds checked, then each layer shape timed."""
    from chip_smoke import PALLAS_TOL, pallas_case, random_model
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    import torch

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
        run_ms("egnn_pallas", {"layer": layer},
               lambda k: lambda: ep.launch(libs[k], *args, stream=stream))


def loop_ab(libs, card, dev, run_ms) -> None:
    """The loop kernels: both builds' forward and backward checked in both
    modes, then the backward timed per layer shape and mode."""
    from chip_smoke import LOOP_TOL, loop_case, loop_errors, loop_named, loop_run, random_model
    from pmhc_tpu_torch.ops import egnn_loop as el

    import torch

    model = random_model(seed=0).to(dev).eval()
    stream = torch.cuda.current_stream().cuda_stream
    for k, layer in enumerate(("gnn1", "gnn2")):
        args, cts = loop_case(model, layer, seed=10 + k, device=dev)
        for mode in ("fp32", "bf16"):
            bf16 = mode == "bf16"
            want = loop_run(args, cts, bf16, kernel=False)
            for name in ("old", "new"):
                outs = el.launch_fwd(libs[name], *args, bf16=bf16, stream=stream)
                got = loop_named(outs, el.launch_bwd(libs[name], *args, outs[0], cts, bf16=bf16,
                                                     stream=stream))
                torch.cuda.synchronize()
                res = loop_errors(got, want, LOOP_TOL[mode])
                bad = {n: r for n, r in res.items() if not r[3]}
                worst = max(res.items(), key=lambda kv: kv[1][1])
                print(json.dumps({"check": name, "layer": layer, "mode": mode, "ok": not bad,
                                  "worst": [worst[0], worst[1][0], worst[1][1]]}), flush=True)
                if bad:
                    raise AssertionError(f"{name} loop kernels disagree with the plain version on "
                                         f"{layer} {mode}: {bad}")
            m = el.launch_fwd(libs["new"], *args, bf16=bf16, stream=stream)[0]
            run_ms("egnn_loop_bwd", {"layer": layer, "mode": mode},
                   lambda n: lambda: el.launch_bwd(libs[n], *args, m, cts, bf16=bf16, stream=stream))
            if "phases" in libs:
                loop_phases(libs["phases"], lambda: el.launch_bwd(libs["phases"], *args, m, cts,
                                                                  bf16=bf16, stream=stream),
                            {"layer": layer, "mode": mode}, card)


PHASES = ("row_setup", "S0_build", "S1_head_lin2", "S2_B", "S3_lin2_bwd", "P_products_F", "row_end")


def loop_phases(lib, launch, labels: dict, card: str, launches: int = 20) -> None:
    """The backward's cycle counters (built with -DPMHC_LOOP_PHASES) over
    ``launches`` launches: per phase, the cycles from barrier to barrier and
    each warp's cycles to its arrival at the closing barrier, per launch,
    summed over the blocks and over each block's rows and tiles."""
    import ctypes

    import numpy as np
    import torch

    lib.egnn_loop_bwd_phases.argtypes = [ctypes.c_void_p]
    lib.egnn_loop_bwd_phases.restype = ctypes.c_int
    buf = np.zeros((12 + 1, len(PHASES)), dtype=np.uint64)  # [12 warps + thread 0][phase]
    launch()
    torch.cuda.synchronize()
    assert lib.egnn_loop_bwd_phases(buf.ctypes.data) == 0
    for _ in range(launches):
        launch()
    torch.cuda.synchronize()
    assert lib.egnn_loop_bwd_phases(buf.ctypes.data) == 0
    per = buf.astype(np.float64) / launches
    print(json.dumps({"metric": "egnn_loop_bwd_phase_cycles", **labels, "launches": launches,
                      "per_launch_all_blocks": {ph: float(per[12, k]) for k, ph in enumerate(PHASES)},
                      "warp_busy_per_launch_all_blocks": {
                          ph: [float(x) for x in per[:12, k]] for k, ph in enumerate(PHASES)},
                      "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="an earlier version of the kernel's source")
    ap.add_argument("--kernel", choices=sorted(ABLATIONS), default="pallas",
                    help="pallas: egnn_pallas.cu (kernel #3); loop: egnn_loop.cu (its backward, #6/#7)")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", action="store_true",
                    help="loop: also build the source with -DPMHC_LOOP_PHASES and report the "
                         "backward's cycles per phase and warp")
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    import ctypes

    import torch

    from chip_smoke import card_line, time_ms
    from pmhc_tpu_torch.ops import _build
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    source, bind, ab = {"pallas": ("egnn_pallas", ep.bind, pallas_ab),
                        "loop": ("egnn_loop", el.bind, loop_ab)}[opts.kernel]
    with open(os.path.join(_build.CSRC, source + ".cu")) as f:
        new_src = f.read()
    with open(opts.old) as f:
        sources = {"old": f.read(), "new": new_src}
    if opts.ablate:
        for name, edits in ABLATIONS[opts.kernel].items():
            sources[name] = ablated(new_src, edits)
    jobs = {k: (v, ()) for k, v in sources.items()}
    if opts.phases and opts.kernel == "loop":
        jobs["phases"] = (new_src, ("-DPMHC_LOOP_PHASES",))
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(lambda kv: build(f"{source}_{kv[0]}", *kv[1]), jobs.items())))
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    libs = {k: bind(ctypes.CDLL(p)) for k, p in paths.items()}

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def run_ms(metric: str, labels: dict, launcher) -> None:
        """The old and new builds in turns, then each ablation beside new."""
        run = lambda k: time_ms(launcher(k), ITERS)
        turns = [(k, run(k)) for k in ("old", "new", "new", "old")]
        print(json.dumps({"metric": f"{metric}_ab_ms", **labels, "turns": turns, "iters": ITERS,
                          "card": card}), flush=True)
        for name in (k for k in libs if k not in ("old", "new", "phases")):
            print(json.dumps({"metric": f"{metric}_ablation_ms", **labels, "ablation": name,
                              "ms": run(name), "new_ms": run("new"), "card": card}), flush=True)

    ab(libs, card, dev, run_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
