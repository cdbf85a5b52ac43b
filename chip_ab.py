#!/usr/bin/env python3
"""Time two builds of a kernel on one card, in turns, and the current source
with one phase removed at a time: kernel #3 (``csrc/egnn_pallas.cu``),
the training loop's forward and backward (``csrc/egnn_loop.cu``, TPU
kernels #4-#7) or the fused sampler layer (``csrc/egnn_fused.cu``, TPU
kernels #1 and #2).

    python3 chip_ab.py OLD.cu [--kernel pallas|loop|fused] [--ablate] [--phases]

``OLD.cu`` is an earlier version of the source, e.g. the parent commit's,
with the parent's headers that differ from the current ones beside it
(headers are looked up in OLD.cu's directory before ``csrc/``):

    mkdir -p .chip_scratch/old
    git show HEAD~1:pmhc_tpu_torch/csrc/egnn_pallas.cu > .chip_scratch/old/egnn_pallas.cu
    git show HEAD~1:pmhc_tpu_torch/csrc/egnn_loop.cu > .chip_scratch/old/egnn_loop.cu
    git show HEAD~1:pmhc_tpu_torch/csrc/egnn_common.cuh > .chip_scratch/old/egnn_common.cuh

Both are built with ``ops/_build.NVCC_FLAGS`` (one nvcc each, in parallel)
into ``.chip_scratch/build/`` and bound with the wrapper's ``bind``. Kernel
#3: checked against ``egnn_pallas_plain`` at ``chip_smoke.PALLAS_TOL`` on
``chip_smoke.pallas_case``'s batch-64 inputs for both layer shapes, then
each layer shape timed. The loop: forward and backward of both builds
checked against the plain version and its autograd
(``chip_smoke.loop_run(..., kernel=False)``) at ``chip_smoke.LOOP_TOL`` on
``chip_smoke.loop_case``'s batch-64 inputs, both layer shapes and every
mode (fp32, bf16, high), then the forward and the backward timed per layer and mode. The
fused layer: both builds checked against ``egnn_fused_plain`` at
``chip_smoke.TOL`` on ``chip_smoke.layer_case``'s batch-64 inputs (B=64,
N=16, NP=96), both layer shapes and every mode, then timed per layer and
mode. Times
are ``chip_smoke.time_ms`` (``ITERS`` launches captured in a CUDA graph,
its replay timed between CUDA events: the card's time, not the host's
launch work) in the order old, new, new, old. ``--ablate`` also builds copies of the current
source with one phase removed (textual edits, ``ABLATIONS``; their
outputs are wrong, they are timed only) and times each beside the
current source; the loop's ``fwd_*`` ablations on the forward, the others
on the backward. An ablation edits the kernel's ``.cu`` or, where an
edit names a header, a copy of that header that the ablated build finds
first. ``--phases`` (loop) also builds
the current source with ``-DPMHC_LOOP_PHASES`` and prints the backward's
clock64 cycles per phase (barrier to barrier) and per warp (to its arrival
at the phase's closing barrier), summed over the blocks; (fused) with
``-DPMHC_FUSED_PHASES``, the high kernel's cycles per warp in each phase
of its role (its warpgroups overlap, so ablations alone cannot split it). One JSON line per
measurement, the card's name and power limit first.
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

# egnn_high.cuh, the high pipeline of the fused layer and the loop forward
# (its head product, issue_head, is also the loop backward's): the head
# product (issue_head's twelve m64n64k16), the lin2 (epilogue_head's twelve
# m64n16k16; without them the epilogue is dead), the build, the fold, the
# merge and the next item's prefetch
_HIGH = "egnn_high.cuh"
_HIGH_HEAD_PRODUCT = (_HIGH, "    wgmma_ss<64, 0, 0>(acc, da_h + 2 * ks, db_h + 2 * ks, ks > 0);\n"
                             "    wgmma_ss<64, 0, 0>(acc, da_h + 2 * ks, db_l + 2 * ks, 1);\n"
                             "    wgmma_ss<64, 0, 0>(acc, da_l + 2 * ks, db_h + 2 * ks, 1);\n", "")
_HIGH_LIN2 = (_HIGH, "    wgmma_rs<16, 0>(lacc, lh[t], d2h + 2 * t, HEAD > 0 || t > 0);\n"
                     "    wgmma_rs<16, 0>(lacc, lh[t], d2l + 2 * t, 1);\n"
                     "    wgmma_rs<16, 0>(lacc, ll[t], d2h + 2 * t, 1);\n", "")
_HIGH_BUILD = [(_HIGH, "      for (int j = pw; j < TILE; j += 4) {", "      for (int j = pw; j < 0; j += 4) {"),
               (_HIGH, "      if (pt < TILE) {\n        float* gr", "      if (pt < 0) {\n        float* gr")]
_HIGH_FOLD = (_HIGH, "      fold_rows(sm + S::GEOS + buf * TILE * GEO_LD,", "      if (false) fold_rows(sm + S::GEOS + buf * TILE * GEO_LD,")
_HIGH_MERGE = (_HIGH, "  merge_partials(sm + S::FR, fp, tl == 0, lane);\n", "")
_HIGH_PREFETCH = (_HIGH, "      if (it + 1 < items) {\n        const int nrow", "      if (it + 1 < 0) {\n        const int nrow")

# kernel -> name -> [(text in the source, its replacement), ...]: each
# removes one phase; every text must occur in the source (all its
# occurrences are replaced). An edit (header, text, replacement) edits the
# header ``csrc/<header>`` instead of the kernel's .cu.
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
    # (each names its fp32, bf16 and high form; texts shared by the modes,
    # as the staging, phases B, E and F and the atomics, once). high: the
    # backward's head products are the forward half's and part 1's
    # (issue_head) and part 2's act^T
    "no_head_product": [("for (int k0 = 0; k0 < T; k0 += 4) {", "for (int k0 = 0; k0 < 0; k0 += 4) {"),
                        ("        mma_bf16_16816(cc[nn], a[ks], b);\n", ""), _HIGH_HEAD_PRODUCT,
                        ("    wgmma_ss<48, 0, 0>(accT, dwh + HEAD * D_HEAD + 2 * ks, dah + 2 * ks, ks > 0);\n"
                         "    wgmma_ss<48, 0, 0>(accT, dwh + HEAD * D_HEAD + 2 * ks, dal + 2 * ks, 1);\n"
                         "    wgmma_ss<48, 0, 0>(accT, dwl + HEAD * D_HEAD + 2 * ks, dah + 2 * ks, 1);\n", "")],
    "no_dwhm_product": [("p3_bf16(sm, warp, lane);", ""), ("p3_fp32(sm, warp, lane);", ""),
                        ("    wgmma_rs<64, 1>(dwc, dh[s3], dah_mn + s3 * D_K16, s3 > 0);\n"
                         "    wgmma_rs<64, 1>(dwc, dh[s3], dal_mn + s3 * D_K16, 1);\n"
                         "    wgmma_rs<64, 1>(dwc, dl[s3], dah_mn + s3 * D_K16, 1);\n", "")],
    "no_dhid_product": [("for (int k0 = 0; k0 < HEADS; k0 += 4) {", "for (int k0 = 0; k0 < 0; k0 += 4) {"),
                        ("for (int ks = 0; ks < HEADS / 16; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),
                        ("    wgmma_rs<64, 1>(dhid, fh[t], bh, HEAD > 0 || t > 0);\n"
                         "    wgmma_rs<64, 1>(dhid, fh[t], bl, 1);\n"
                         "    wgmma_rs<64, 1>(dhid, fl[t], bh, 1);\n", "")],
    # d(a_j), d(edge) (2 per pair and column) and phase F's d(q_j), d(t_j)
    "no_atomics": [("  atomicAdd(reinterpret_cast<float4*>(io.daj + aj_at), v);\n", ""),
                   ("  atomicAdd(reinterpret_cast<float4*>(io.dedge + edge_at), v);\n", ""),
                   ("  atomicAdd(reinterpret_cast<float2*>(io.daj + aj_at), v);\n", ""),
                   ("  atomicAdd(reinterpret_cast<float2*>(io.dedge + edge_at), v);\n", ""),
                   ("atomicAdd(io.dqj + ((size_t)b * NP + j) * 4 + c, dqj[c]);", "(void)dqj[c];"),
                   ("atomicAdd(io.dtj + ((size_t)b * NP + j) * 3 + c, dtj[c]);", "(void)dtj[c];")],
    "no_phases_BF": [("if (nbr) {", "if (false) {")],
    "no_E": [("constexpr int NS = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 0;", "constexpr int NS = HEAD < 0 ? 2 : 0;")],
    "no_unit_sums": [("for (int jj = 0; jj < BT; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {"),
                     ("        us[h8][0] += dp;\n#pragma unroll\n"
                      "        for (int s = 0; s < NE; ++s) us[h8][1 + s] = fmaf(dp, ej[s], us[h8][1 + s]);\n", ""),
                     ("      us[h8][s] += __shfl_xor_sync(0xffffffffu, us[h8][s], 1);\n"
                      "      us[h8][s] += __shfl_xor_sync(0xffffffffu, us[h8][s], 2);\n", "")],
    "no_build": [("for (int e = tid; e < (BT / 2) * (T / 2); e += THREADS) {",
                  "for (int e = tid; e < 0; e += THREADS) {"),
                 ("for (int e = tid; e < BT * T / 4; e += THREADS) {", "for (int e = tid; e < 0; e += THREADS) {"),
                 ("    for (int j = pw; j < BT; j += 4) {", "    for (int j = pw; j < 0; j += 4) {")],
    "no_weight_staging": [("for (int e = tid; e < 4 * 8 * 4 * 32; e += THREADS) {",
                           "for (int e = tid; e < 0; e += THREADS) {"),
                          ("for (int e = tid; e < 8 * 16 * 32; e += THREADS) {",
                           "for (int e = tid; e < 0; e += THREADS) {"),
                          ("for (int e = tid; e < HEADS * T / 4; e += THREADS) {\n      const int u",
                           "for (int e = tid; e < 0; e += THREADS) {\n      const int u"),
                          ("  stage_high<S>(sm, tb, loop_w(in.w), tid);\n", "")],
    # the forward (egnn_tile.cuh's phases, called from the forward kernel;
    # high: egnn_high.cuh's)
    "fwd_no_product": [("    tile_product<MODE>(sm, nj, warp, lane);\n", ""), _HIGH_HEAD_PRODUCT, _HIGH_LIN2],
    "fwd_no_fold": [("      fold_tile<MODE>(sm, nj, warp, lane);\n", ""), _HIGH_FOLD],
    "fwd_no_prefetch": [("      prefetch(it + 1, nrow / N != b || ntl != tl);\n", ""), _HIGH_PREFETCH],
    "fwd_no_build": [("    build_tile<MODE>(sm, sm + S::NR + L_AI, sm + S::NR + L_QI, sm + S::NR + L_TI, nj, tid, warp, lane);\n",
                      ""), *_HIGH_BUILD],
    "fwd_no_weight_staging": [("  stage_weights<MODE>(sm, loop_w(in.w), tid);\n", ""),
                              ("  stage_high<S>(sm, tb, loop_w(in.w), tid);\n", "")],
}, "fused": {
    # TPU kernels #1 / #2: the row group's node MLPs (a_i and the torsion
    # node term), the hid tile's build (and split) with the geometry
    # records, the tile product as a whole and its two halves (the head
    # product; the epilogue with the lin2, whose removal leaves the
    # epilogue dead), the fold, the merge, the next tile's prefetch, the
    # feature MLP and the weight staging; each names the fp32 / bf16 tile
    # loop's form (egnn_tile.cuh's phases) and the high kernel's
    "no_node_mlps": [("    if (tl == 0 && r == 0) {\n      const float* nr",
                      "    if (tl == 0 && r < 0) {\n      const float* nr"),
                     ("    node_terms<false>(w, off, sm + S::NS, sm + S::AI, sm + S::TN, rg, H, tid);\n", "")],
    "no_build": [("    build_tile<MODE>(sm, sm + S::AI + r * T, ns + N_Q, ns + N_T, nj, tid, warp, lane);\n", ""),
                 *_HIGH_BUILD],
    "no_product": [("    tile_product<MODE>(sm, nj, warp, lane);\n", ""), _HIGH_HEAD_PRODUCT, _HIGH_LIN2],
    "no_head_product": [
        ("egnn_tile.cuh", "for (int k0 = 0; k0 < T; k0 += 4) {", "for (int k0 = 0; k0 < 0; k0 += 4) {"),
        ("egnn_tile.cuh", "        mma_bf16_16816(cc[0][nn], a[0][ks], b);\n        mma_bf16_16816(cc[1][nn], a[1][ks], b);\n",
         ""),
        _HIGH_HEAD_PRODUCT],
    "no_epilogue_lin2": [
        ("egnn_tile.cuh", "reduce_scatter8<R>(part, sum, lane);", "for (int o = 0; o < R; ++o) sum[o] = acc[0][o];"),
        ("egnn_tile.cuh", "    mma_bf16_16816(lacc[0], la[0], b2);\n    mma_bf16_16816(lacc[1], la[1], b2);\n", ""),
        _HIGH_LIN2],
    "no_fold": [("      fold_tile<MODE>(sm, nj, warp, lane);\n", ""), _HIGH_FOLD],
    "no_merge": [("      merge_tile<MODE>(sm, lane);\n", ""), _HIGH_MERGE],
    "no_prefetch": [("      prefetch(it + 1, nrow / N != b || ntl != tl);\n", ""), _HIGH_PREFETCH],
    "no_feature_mlp": [("    if (tl + 1 < tiles || r + 1 < rg) continue;", "    continue;"),
                       ("    feature_mlp<false>(w, off,", "    if (false) feature_mlp<false>(w, off,")],
    "no_weight_staging": [("  stage_weights<MODE>(sm, LoopW{", "  if (false) stage_weights<MODE>(sm, LoopW{"),
                          ("  stage_high<S>(sm, tb, LoopW{", "  if (false) stage_high<S>(sm, tb, LoopW{")],
}}

SOURCES = {"pallas": "egnn_pallas", "loop": "egnn_loop", "fused": "egnn_fused"}


def build(name: str, source, flags=(), includes=()) -> str:
    """nvcc ``source`` into ``.chip_scratch/build/lib<name>.so``: the
    ``.cu``'s text, or {file: text} of the ``.cu`` (key ``None``) and the
    edited headers, written beside it and found first; then headers from
    ``includes``, then ``csrc/``."""
    from pmhc_tpu_torch.ops import _build

    files = source if isinstance(source, dict) else {None: source}
    hdrs = os.path.join(OUT, f"{name}_include")
    os.makedirs(hdrs, exist_ok=True)
    src = os.path.join(OUT, f"{name}.cu")
    for fname, text in files.items():
        with open(src if fname is None else os.path.join(hdrs, fname), "w") as f:
            f.write(text)
    includes = (hdrs, *includes)
    out = os.path.join(OUT, f"lib{name}.so")
    inc = [a for d in (*includes, _build.CSRC) for a in ("-I", d)]
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
                           *inc, "-o", out, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "wgmma" in ln or "arning" in ln]
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


def ablated_files(kernel: str, edits, csrc: str | None = None) -> dict:
    """{None: the kernel's ablated .cu, header: its ablated text} for one
    ablation of ``ABLATIONS[kernel]``: each edit (text, replacement) on the
    .cu, (header, text, replacement) on ``csrc/<header>``."""
    if csrc is None:
        from pmhc_tpu_torch.ops import _build

        csrc = _build.CSRC
    by_file: dict = {}
    for e in edits:
        fname, find, repl = e if len(e) == 3 else (None, *e)
        by_file.setdefault(fname, []).append((find, repl))
    out = {}
    for fname in (None, *sorted(f for f in by_file if f is not None)):
        with open(os.path.join(csrc, fname or SOURCES[kernel] + ".cu")) as f:
            out[fname] = ablated(f.read(), by_file.get(fname, []))
    return out


def pallas_ab(libs, card, dev, run_ms) -> None:
    """Kernel #3: both builds checked, then each layer shape timed."""
    from chip_smoke import PALLAS_TOL, pallas_case, random_model
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    import torch

    model = random_model(seed=0).to(dev).eval()
    # the current stream at each launch: a capture launches on its own
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for i, layer in enumerate(("gnn1", "gnn2")):
        ctx, step = pallas_case(model, layer, seed=20 + i, device=dev)
        args = ctx.inputs(*step)
        want = ep.egnn_pallas_plain(*args)
        for k in ("old", "new"):
            got = ep.launch(libs[k], *args, stream=cur())
            torch.cuda.synchronize()
            errs = {n: float((g - w).abs().max()) for n, g, w in zip(("q", "t", "tors", "feat"), got, want)}
            ok = all(errs[n] <= PALLAS_TOL[n] for n in errs)
            print(json.dumps({"check": k, "layer": layer, "max_abs_err": errs, "ok": ok}), flush=True)
            if not ok:
                raise AssertionError(f"{k} kernel disagrees with the plain version on {layer}")
        run_ms("egnn_pallas", {"layer": layer},
               lambda k: lambda: ep.launch(libs[k], *args, stream=cur()))


def loop_ab(libs, card, dev, run_ms) -> None:
    """The loop kernels: both builds' forward and backward checked in every
    mode (fp32, bf16, high), then the forward and the backward timed per
    layer shape and mode. An OLD.cu without the high mode fails its check."""
    from chip_smoke import LOOP_TOL, MODES, loop_case, loop_errors, loop_named, loop_run, random_model
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops.egnn_fused import FLAGS

    import torch

    model = random_model(seed=0).to(dev).eval()
    # the current stream at each launch: a capture launches on its own
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for k, layer in enumerate(("gnn1", "gnn2")):
        args, cts = loop_case(model, layer, seed=10 + k, device=dev)
        for mode in MODES:
            bf16 = FLAGS[mode]
            want = loop_run(args, cts, bf16, kernel=False)
            for name in ("old", "new"):
                outs = el.launch_fwd(libs[name], *args, bf16=bf16, stream=cur())
                got = loop_named(outs, el.launch_bwd(libs[name], *args, outs[0], cts, bf16=bf16,
                                                     stream=cur()))
                torch.cuda.synchronize()
                res = loop_errors(got, want, LOOP_TOL[mode])
                bad = {n: r for n, r in res.items() if not r[3]}
                worst = max(res.items(), key=lambda kv: kv[1][1])
                print(json.dumps({"check": name, "layer": layer, "mode": mode, "ok": not bad,
                                  "worst": [worst[0], worst[1][0], worst[1][1]]}), flush=True)
                if bad:
                    raise AssertionError(f"{name} loop kernels disagree with the plain version on "
                                         f"{layer} {mode}: {bad}")
            run_ms("egnn_loop_fwd", {"layer": layer, "mode": mode},
                   lambda n: lambda: el.launch_fwd(libs[n], *args, bf16=bf16, stream=cur()),
                   ablations=lambda a: a.startswith("fwd_"))
            m = el.launch_fwd(libs["new"], *args, bf16=bf16, stream=cur())[0]
            run_ms("egnn_loop_bwd", {"layer": layer, "mode": mode},
                   lambda n: lambda: el.launch_bwd(libs[n], *args, m, cts, bf16=bf16, stream=cur()),
                   ablations=lambda a: not a.startswith("fwd_"))
            if "phases" in libs:
                loop_phases(libs["phases"], lambda: el.launch_bwd(libs["phases"], *args, m, cts,
                                                                  bf16=bf16, stream=cur()),
                            {"layer": layer, "mode": mode}, card)


def fused_ab(libs, card, dev, run_ms) -> None:
    """The fused layer: both builds checked in every mode (fp32, bf16,
    high) against ``egnn_fused_plain`` at ``chip_smoke.TOL``, then timed per
    layer shape and mode (B=64, N=16, NP=96), the ablations beside new."""
    from chip_smoke import MODES, TOL, layer_case, random_model
    from pmhc_tpu_torch.ops import egnn_fused as ef

    import torch

    model = random_model(seed=0).to(dev).eval()
    # the current stream at each launch: a capture launches on its own
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for k, layer in enumerate(("gnn1", "gnn2")):
        args = layer_case(model, layer, seed=30 + k, device=dev)
        for mode in MODES:
            bf16 = ef.FLAGS[mode]
            want = ef.egnn_fused_plain(*args, bf16=bf16)
            for name in ("old", "new"):
                got = ef.launch(libs[name], *args, bf16=bf16, stream=cur())
                torch.cuda.synchronize()
                errs = {n: float((g - w).abs().max()) for n, g, w in zip(("q", "t", "tors", "feat"), got, want)}
                ok = all(errs[n] <= TOL[mode][n] for n in errs)
                print(json.dumps({"check": name, "layer": layer, "mode": mode, "max_abs_err": errs,
                                  "ok": ok}), flush=True)
                if not ok:
                    raise AssertionError(f"{name} fused kernel disagrees with the plain version on "
                                         f"{layer} {mode}")
            run_ms("egnn_fused", {"layer": layer, "mode": mode},
                   lambda n: lambda: ef.launch(libs[n], *args, bf16=bf16, stream=cur()))
            if "phases" in libs and mode == "high":
                fused_phases(libs["phases"], lambda: ef.launch(libs["phases"], *args, bf16=bf16,
                                                               stream=cur()),
                             {"layer": layer, "mode": mode}, card)


FUSED_PHASES = ("c_wait_full", "c_issue_operands", "c_wait_head_products", "c_epilogues_lin2", "c_store_arrive",
                "p_wait_raw", "p_build", "p_prefetch_hid_sums", "p_wait_done", "p_fold", "p_merge",
                "group_setup_features_staging")


def fused_phases(lib, launch, labels: dict, card: str, launches: int = 20) -> None:
    """The high kernel's cycle counters (built with -DPMHC_FUSED_PHASES)
    over ``launches`` launches: per warp (0-7 consumers, 8-11 the producer)
    the cycles in each phase of its role, per launch, summed over the
    blocks; and per phase the mean over the warps of that role."""
    import ctypes

    import numpy as np
    import torch

    lib.egnn_fused_phases.argtypes = [ctypes.c_void_p]
    lib.egnn_fused_phases.restype = ctypes.c_int
    buf = np.zeros((12, len(FUSED_PHASES)), dtype=np.uint64)  # [warp][phase]
    launch()
    torch.cuda.synchronize()
    assert lib.egnn_fused_phases(buf.ctypes.data) == 0
    for _ in range(launches):
        launch()
    torch.cuda.synchronize()
    assert lib.egnn_fused_phases(buf.ctypes.data) == 0
    per = buf.astype(np.float64) / launches
    role = {ph: (slice(0, 8) if ph.startswith("c_") else slice(8, 12) if ph.startswith("p_") else slice(0, 12))
            for ph in FUSED_PHASES}
    print(json.dumps({"metric": "egnn_fused_high_phase_cycles", **labels, "launches": launches,
                      "mean_warp_per_launch_all_blocks": {ph: float(per[role[ph], k].mean())
                                                          for k, ph in enumerate(FUSED_PHASES)},
                      "warp_per_launch_all_blocks": {ph: [float(x) for x in per[:, k]]
                                                     for k, ph in enumerate(FUSED_PHASES)},
                      "card": card}), flush=True)


PHASES = ("row_setup", "S0_build", "S1_head_lin2", "S2_B", "S3_lin2_bwd", "P_products_F", "row_end")
# the high kernel's phases of each role (egnn_loop.cu, RoleClock): consumers
# (warps 0-7) and the producer (warps 8-11) share the counters' columns
HIGH_PHASES = {"consumer": ("c_wait_full", "c_forward_half", "c_phase_B", "c_part1_dhid_E", "c_dhid_out_F_sums",
                            "c_part2_dW2_units_dwhm", "c_ordered_adds"),
               "producer": ("p_wait_empty", "p_row_inputs", "p_build_hid", "p_geometry")}


def loop_phases(lib, launch, labels: dict, card: str, launches: int = 20) -> None:
    """The backward's cycle counters (built with -DPMHC_LOOP_PHASES) over
    ``launches`` launches: per phase, the cycles from barrier to barrier and
    each warp's cycles to its arrival at the closing barrier, per launch,
    summed over the blocks and over each block's rows and tiles. The high
    kernel (``labels["mode"] == "high"``) counts per warp the cycles of each
    phase of its role (``HIGH_PHASES``): the mean over the role's warps."""
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
    if labels.get("mode") == "high":
        roles = {"consumer": slice(0, 8), "producer": slice(8, 12)}
        print(json.dumps({"metric": "egnn_loop_bwd_high_phase_cycles", **labels, "launches": launches,
                          "mean_warp_per_launch_all_blocks": {
                              ph: float(per[roles[role], k].mean())
                              for role, names in HIGH_PHASES.items() for k, ph in enumerate(names)},
                          "warp_per_launch_all_blocks": {str(w): [float(x) for x in per[w]] for w in range(12)},
                          "card": card}), flush=True)
        return
    print(json.dumps({"metric": "egnn_loop_bwd_phase_cycles", **labels, "launches": launches,
                      "per_launch_all_blocks": {ph: float(per[12, k]) for k, ph in enumerate(PHASES)},
                      "warp_busy_per_launch_all_blocks": {
                          ph: [float(x) for x in per[:12, k]] for k, ph in enumerate(PHASES)},
                      "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="an earlier version of the kernel's source")
    ap.add_argument("--kernel", choices=sorted(ABLATIONS), default="pallas",
                    help="pallas: egnn_pallas.cu (kernel #3); loop: egnn_loop.cu (#4-#7); "
                         "fused: egnn_fused.cu (#1, #2)")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", action="store_true",
                    help="loop: also build the source with -DPMHC_LOOP_PHASES and report the "
                         "backward's cycles per phase and warp; fused: -DPMHC_FUSED_PHASES, the "
                         "high kernel's cycles per phase and warp")
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    import ctypes

    import torch

    from chip_smoke import card_line, time_ms
    from pmhc_tpu_torch.ops import _build
    from pmhc_tpu_torch.ops import egnn_fused as ef
    from pmhc_tpu_torch.ops import egnn_loop as el
    from pmhc_tpu_torch.ops import egnn_pallas as ep

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    source = SOURCES[opts.kernel]
    bind, ab = {"pallas": (ep.bind, pallas_ab), "loop": (el.bind, loop_ab),
                "fused": (ef.bind, fused_ab)}[opts.kernel]
    with open(os.path.join(_build.CSRC, source + ".cu")) as f:
        new_src = f.read()
    with open(opts.old) as f:
        sources = {"old": f.read(), "new": new_src}
    if opts.ablate:
        for name, edits in ABLATIONS[opts.kernel].items():
            sources[name] = ablated_files(opts.kernel, edits)
    jobs = {k: (v, (), ()) for k, v in sources.items()}
    jobs["old"] = (sources["old"], (), (os.path.dirname(os.path.abspath(opts.old)),))
    if opts.phases and opts.kernel in ("loop", "fused"):
        jobs["phases"] = (new_src, ("-DPMHC_LOOP_PHASES" if opts.kernel == "loop" else "-DPMHC_FUSED_PHASES",), ())
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(lambda kv: build(f"{source}_{kv[0]}", *kv[1]), jobs.items())))
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    libs = {k: bind(ctypes.CDLL(p)) for k, p in paths.items()}

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def run_ms(metric: str, labels: dict, launcher, ablations=lambda name: True) -> None:
        """The old and new builds in turns, then each ablation that
        ``ablations`` selects beside new."""
        run = lambda k: time_ms(launcher(k), ITERS)
        turns = [(k, run(k)) for k in ("old", "new", "new", "old")]
        print(json.dumps({"metric": f"{metric}_ab_ms", **labels, "turns": turns, "iters": ITERS,
                          "card": card}), flush=True)
        for name in (k for k in libs if k not in ("old", "new", "phases") and ablations(k)):
            print(json.dumps({"metric": f"{metric}_ablation_ms", **labels, "ablation": name,
                              "ms": run(name), "new_ms": run("new"), "card": card}), flush=True)

    ab(libs, card, dev, run_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
