"""Analytic FLOP counts of the score network and what a measured rate
achieves of the H100's peaks.

The twin of the JAX package's ``tools/flops.py``: ``layer_flops`` and
``forward_flops`` count the same multiply-adds (2 FLOP each) from the
reference dimensions; a train step is 3x the forward, a T-step sampler T
forwards. The MLP hidden ("transition") width stays 64 when
``--inner-size`` / ``--message-size`` scale.

The peaks are the H100 SXM's published dense rates (they are also what
``chip_smoke.py`` bounds each kernel by): fp32 67 TFLOP/s on the CUDA
cores, bf16 989 TFLOP/s on the tensor cores, fast-f32 (``--fast-f32``:
each product three bf16 passes of its split operands) a third of the
bf16 peak, HBM 3.35 TB/s. No measured rate is built in: pass them
(``--sample-per-sec``, ``--train-steps-per-sec``) or the JSON lines of the
bench tools (``--from-json``), e.g.

    python -m pmhc_tpu_torch.tools.bench_sampler > s.jsonl
    python -m pmhc_tpu_torch.tools.flops --from-json s.jsonl
"""

from __future__ import annotations

import json
from argparse import ArgumentParser
from typing import Any, Dict, List

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAKS = {"f32": PEAK_FP32, "bf16": PEAK_BF16, "fast-f32": PEAK_BF16 / 3}
TRANSITION = 64  # the MLPs' hidden width, fixed by the architecture


def layer_flops(B, N=16, P=80, H=23, T=64, M=64, O=64, E=31):
    """Exact MAC-based FLOPs (2 per MAC) for one EGNN layer forward."""
    NP = N + P
    R = B * N * NP
    f = 0
    # message: a_i [B,N,H]@[H,T], a_j [B,NP,H]@[H,T], lin2 R@[T,M]
    f += 2 * B * N * H * T + 2 * B * NP * H * T + 2 * R * T * M
    f += 3 * R * T  # pre-activation adds (a_i + a_j + edge + bias)
    # attention: lin1 R@[M,T] + 2 rank-1 terms, lin2 R@[T,1]
    f += 2 * R * M * T + 4 * R * T + 2 * R * T * 1
    # feature: [B,N,H+M]@[.,T] + [B,N,T]@[T,O]
    f += 2 * B * N * (H + M) * T + 2 * B * N * T * O
    # translation: lin1 R@[M,T], lin2 R@[T,1]
    f += 2 * R * M * T + 2 * R * T * 1
    # rotation: lin1 R@[M+4,T], lin2 R@[T,4], 3 quat products (~28 ops each)
    f += 2 * R * (M + 4) * T + 2 * R * T * 4 + 3 * 28 * R
    # torsion: lin1 R@[M,T] + node [B,N,14]@[14,T], lin2 R@[T,7]
    f += 2 * R * M * T + 2 * B * N * 14 * T + 2 * R * T * 7
    # softmax + weighted reductions (exp, normalize, 4 weighted sums)
    f += R * (4 + 4 + 7 + 3 + M)
    return f


def forward_flops(B, I=64, M=64):  # noqa: E741 (the reference's name)
    """Both layers: H=23 -> O=I, then H=I -> O=1; the transition width stays
    ``TRANSITION`` whatever ``I`` / ``M`` are."""
    T = TRANSITION
    return layer_flops(B, H=23, T=T, M=M, O=I) + layer_flops(B, H=I, T=T, M=M, O=1)


def ipa_attention_bound(B: int, L: int = 96) -> Dict[str, Any]:
    """One launch of the IPA attention kernel (``ops/ipa_attention.py``)
    over B complexes of L rows at its compiled widths: its FLOPs (the pair
    bias z . w_b, q . k, 9 a query/key point pair, a . v, a . v_pts, a . z,
    and o_pt back into frame i), its logical bytes (z, q, k, v, the points,
    frames and mask read once, the output written once, the weights), and
    the least time, the larger of the two at the fp32 and HBM peaks."""
    from pmhc_tpu_torch.ops.ipa_attention import HEADS as H, HIDDEN as C, OUT, PAIR as Cz, \
        QK_POINTS as Pq, V_POINTS as Pv

    pair = 2 * H * Cz + 2 * H * C + 9 * H * Pq + 2 * H * C + 2 * H * Pv * 3 + 2 * H * Cz
    flops = B * (L * L * pair + L * 18 * H * Pv)
    per_row = H * C + 2 * H * C + H * Pq * 3 + H * (Pq + Pv) * 3 + 9 + 3 + 1 + OUT
    nbytes = 4 * (B * L * L * Cz + B * L * per_row + H * Cz + 2 * H)
    by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_FP32 else "flops"
    return {"flops": flops, "bytes": nbytes, "bound_by": by,
            "bound_s": max(flops / PEAK_FP32, nbytes / PEAK_BYTES)}


def achieved(kind: str, batch: int, per_sec: float, precision: str, I=64, M=64) -> Dict[str, Any]:
    """TFLOP/s and share of the precision's peak of ``per_sec`` train steps
    (``kind="train"``) or sampler steps (``"sample"``) at ``batch``."""
    flops = (3 if kind == "train" else 1) * forward_flops(batch, I, M)
    rate = flops * per_sec
    peak = PEAKS[precision]
    return {"kind": kind, "batch": batch, "precision": precision, "per_sec": per_sec,
            "achieved_tflops": rate / 1e12, "peak_tflops": peak / 1e12,
            "peak_share_pct": 100 * rate / peak}


def from_bench_lines(lines) -> List[Dict[str, Any]]:
    """``achieved`` for each JSON line of ``bench_sampler`` (samples/s of a
    T-step chain: steps/s = samples/s x steps / batch) or ``bench_train``
    (``steps_per_sec``); other lines are skipped. Each keeps its ``card``."""
    out = []
    for line in lines:
        line = line.strip()
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if "samples_per_sec" in row:
            steps = row["samples_per_sec"] * row["sample_steps"] / row["batch_size"]
            res = achieved("sample", row["batch_size"], steps, row["precision"])
        elif "steps_per_sec" in row:
            res = achieved("train", row["batch_size"], row["steps_per_sec"], row["precision"])
        else:
            continue
        out.append({**res, "backend": row.get("backend"), "card": row.get("card")})
    return out


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--inner-size", type=int, default=64)
    p.add_argument("--message-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=1000, help="the sampler's steps (T)")
    p.add_argument("--precision", default="f32", choices=sorted(PEAKS))
    p.add_argument("--sample-per-sec", type=float, default=None,
                   help="measured samples/s of a --steps chain at --batch")
    p.add_argument("--train-steps-per-sec", type=float, default=None,
                   help="measured train steps/s at --batch")
    p.add_argument("--from-json", default=None, metavar="PATH",
                   help="JSON lines of bench_sampler / bench_train")
    return p


def main(argv=None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    B, I, M = args.batch, args.inner_size, args.message_size
    fwd = forward_flops(B, I, M)
    rows = [{"batch": B, "inner_size": I, "message_size": M, "forward_gflops": fwd / 1e9,
             "train_step_gflops": 3 * fwd / 1e9,
             "sampler_gflops_per_batch": fwd * args.steps / 1e9, "steps": args.steps}]
    if args.sample_per_sec is not None:
        steps = args.sample_per_sec * args.steps / B
        rows.append(achieved("sample", B, steps, args.precision, I, M))
    if args.train_steps_per_sec is not None:
        rows.append(achieved("train", B, args.train_steps_per_sec, args.precision, I, M))
    if args.from_json:
        with open(args.from_json) as f:
            rows += from_bench_lines(f)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
