"""Serving throughput and latency through the port's HTTP server.

The twin of the JAX package's ``tools/bench_serve.py``. Starts
``cli/serve_cli.py``'s server in-process on an ephemeral port and fires
concurrent clients at ``POST /sample`` (one npz entry in, one PDB out):
HTTP parse, micro-batching, the sampler on the card, PDB text, response.
The request bodies are a few realistic entries (``data/realistic.py``,
seed 11) made into request entries by ``serve.entry_from_dataset``,
round-robined.

    python -m pmhc_tpu_torch.tools.bench_serve [--backend auto] [--concurrency 8,64] [--requests 256]

One JSON line for ``--warmup-requests`` (after the service's own warm-up,
which builds the kernels and captures the chain; ``"warmup": true``), then
one per ``--concurrency`` level:
requests/s and the latency p50 / p90 / p99 / max in seconds, errors by
kind, the batches the server dispatched, the card's name and power limit.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import shutil
import statistics
import tempfile
import threading
import time
from argparse import ArgumentParser
from typing import Any, Dict, List

import numpy as np


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default=None,
                   help=".pth weights (default: random weights from seed 0; the time does "
                        "not depend on them)")
    p.add_argument("--batch-size", "-b", type=int, default=64)
    p.add_argument("-T", type=int, default=1000)
    p.add_argument("--sample-steps", type=int, default=None)
    p.add_argument("--backend", default="auto", choices=("auto", "xla", "pallas", "pallas_lane", "g8"))
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast-f32", action="store_true")
    p.add_argument("--max-wait-ms", type=float, default=25.0)
    p.add_argument("--concurrency", default="128",
                   help="concurrent client threads; a comma list sweeps offered load against "
                        "the same warm server")
    p.add_argument("--requests", type=int, default=256, help="requests per concurrency level")
    p.add_argument("--warmup-requests", type=int, default=8)
    p.add_argument("--max-queue", type=int, default=None,
                   help="passed to serve_cli (503s are counted as 'HTTP 503' errors)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the server (default: the card)")
    return p


def request_bodies(n: int = 8, seed: int = 11) -> List[bytes]:
    """npz bodies of ``n`` realistic request entries."""
    from pmhc_tpu_torch.data.realistic import realistic_packed
    from pmhc_tpu_torch.serve import entry_from_dataset

    ds = realistic_packed(n, seed)
    bodies = []
    for name in ds.entry_names:
        buf = io.BytesIO()
        np.savez(buf, **entry_from_dataset(ds, name))
        bodies.append(buf.getvalue())
    return bodies


def quantile(sorted_values: List[float], q: float) -> float:
    return sorted_values[min(len(sorted_values) - 1, int(q * len(sorted_values)))]


def main(argv=None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    import torch

    from pmhc_tpu_torch.cli.serve_cli import build_parser as serve_parser
    from pmhc_tpu_torch.cli.serve_cli import create_server
    from pmhc_tpu_torch.tools import card_line, random_params

    tmp = tempfile.mkdtemp(prefix="bench_serve_")
    try:
        model_path = args.model
        if model_path is None:
            model_path = os.path.join(tmp, "model.pth")
            torch.save(random_params(), model_path)
        cli = [model_path, "--port", "0", "--batch-size", str(args.batch_size), "-T", str(args.T),
               "--backend", args.backend, "--max-wait-ms", str(args.max_wait_ms),
               "--device", args.device]
        if args.max_queue is not None:
            cli += ["--max-queue", str(args.max_queue)]
        if args.sample_steps:
            cli += ["--sample-steps", str(args.sample_steps)]
        if args.bf16:
            cli.append("--bf16")
        if args.fast_f32:
            cli.append("--fast-f32")
        server = create_server(serve_parser().parse_args(cli))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    service = server.batcher.service
    card = card_line(service.device)
    host, port = server.server_address
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    bodies = request_bodies()

    def post(body: bytes) -> float:
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection(host, port, timeout=900)
        try:
            conn.request("POST", "/sample", body)
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        if not data.rstrip().endswith(b"END"):
            raise RuntimeError("truncated PDB response")
        return time.perf_counter() - t0

    def run_level(conc: int, n_requests: int) -> Dict[str, Any]:
        latencies: List[float] = []
        errors: Dict[str, int] = {}
        lock = threading.Lock()
        counter = iter(range(n_requests))
        batches0 = server.batcher.batches

        def client():
            while True:
                with lock:
                    i = next(counter, None)
                if i is None:
                    return
                try:
                    dt = post(bodies[i % len(bodies)])
                    with lock:
                        latencies.append(dt)
                except Exception as e:  # noqa: BLE001 — bucketed, the clients go on
                    kind = str(e)[:8] if str(e).startswith("HTTP ") else type(e).__name__
                    with lock:
                        errors[kind] = errors.get(kind, 0) + 1

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(min(conc, n_requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        lat = sorted(latencies)
        return {"concurrency": conc, "ok": len(lat), "requests": n_requests, "wall_s": wall,
                "requests_per_sec": len(lat) / wall if lat else 0.0,
                "p50_s": statistics.median(lat) if lat else None,
                "p90_s": quantile(lat, 0.90) if lat else None,
                "p99_s": quantile(lat, 0.99) if lat else None,
                "max_s": lat[-1] if lat else None, "errors": errors,
                "batches": server.batcher.batches - batches0}

    config = {"batch_size": args.batch_size, "T": args.T,
              "sample_steps": args.sample_steps or args.T, "backend": service.backend,
              "precision": service.precision, "max_wait_ms": args.max_wait_ms,
              "device": str(service.device), "card": card}
    rows = []

    def report(level: Dict[str, Any], warmup: bool) -> None:
        rows.append({**level, "warmup": warmup, **config})
        print(json.dumps(rows[-1]), flush=True)

    try:
        report(run_level(args.warmup_requests, args.warmup_requests), True)
        for conc in str(args.concurrency).split(","):
            report(run_level(int(conc), args.requests), False)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=30)
    return rows


if __name__ == "__main__":
    main()
