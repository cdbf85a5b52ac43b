"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's set-up (inputs and weights from the
seed, the program built, its kernels loaded and its shapes warmed up) counts as
``setup_s``, from the start of this process to the start of the measured
window. ``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
profiles a span of the window and reports its per-layer metrics, ``device``'s
``busy_s`` and ``window_s`` and the ``breakdown``. After the window the outputs
are compared with the plain reference (``benchmark/reference``); the numbers
compared and their limits are the last lines on standard error and the last
key of the result. Exits non-zero without a result when the cell's cards are
not there, or when JAX or the JAX package were loaded, in this process or in
one the driver started.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from argparse import ArgumentParser  # noqa: E402


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def cache_dirs(root: str) -> None:
    """Keep the compilers' caches inside the checkout, at fixed paths (the
    program's own nvcc builds go to ``pmhc_tpu_torch/csrc/build``)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result(record, trace: bool, card: str) -> dict:
    from benchmark import harness

    metrics = {}
    for m in (record.cell.per_layer if trace else record.cell.end_to_end):
        value = harness.read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": card, "count": record.cards,
              "memory_peak_bytes": int(record.memory_peak_bytes)}
    out = {"correct": harness.verdict(record), "attempted": record.attempted,
           "failed": record.failed, "metrics": metrics, "device": device}
    if trace and record.trace is not None:
        device["busy_s"] = record.counters["busy_s"]
        device["window_s"] = record.counters["trace_window_s"]
        out["breakdown"] = record.trace.breakdown()
    out["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                     for k, v in harness.checks_line(record).items()}
    out["checks"]["failed"] = {"value": record.failed, "limit": 0}
    return out


def forbidden(record) -> list:
    """Modules of JAX or the JAX package loaded in this process or in one the
    driver started (a mesh's ranks)."""
    from benchmark import harness

    return sorted(set(harness.forbidden_modules(sys.modules)) | set(record.forbidden))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from benchmark import harness

    cache_dirs(harness.ROOT)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {have} found", file=sys.stderr)
        return 2
    record = harness.driver(cell.traffic["driver"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=T0)
    card = torch.cuda.get_device_name(0)
    bad = forbidden(record)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    line = result(record, bool(args.trace), card)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
