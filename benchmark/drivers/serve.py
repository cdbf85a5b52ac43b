"""HTTP serving under open-loop load.

The program: ``cli/serve_cli.py``'s server (``create_server``: the resident
``SamplerService`` warmed up, the micro-batching ``BatchingSampler`` with the
CLI's defaults, ``ThreadingHTTPServer``), in this process on an ephemeral
port. The load: one separate process (``benchmark/loadgen.py``) sends
``POST /sample``, one pool entry a request, at arrival times drawn from the
seed: ``round(rate * seconds)`` arrivals with exponential gaps, the same set
of gaps for every seed in another order (``schedule``). A request's latency runs from its due time to the last byte of its
answer. The window's traffic follows ``warmup_seconds`` of the same traffic
without a break (set-up), so the window opens on a loaded server. After the
last arrival the requests still open are drained (up to ``drain_s``) and
counted. A traced run then sends ``trace_seconds`` more of the same traffic
under the profiler.

Check: the dispatched batch that holds a request drawn from the seed among
the first ones of the window; its requests' answers, as the client read
them, against the reference.
"""

from __future__ import annotations

import io
import math
import os
import sys
import tempfile
import threading

import numpy as np

from benchmark.drivers.sample import check_batches
from benchmark.harness import Record
from benchmark.hooks import ChainTap, ServiceTap, entry_key, pick
from benchmark.inputs import make_pool, request_entry
from benchmark.loadgen import LoadGenerator
from benchmark.reference import model as ref
from benchmark.trace import Tracer

# the traffic's sizes cut to what the CPU runs in seconds (``benchmark/tests/tiny.py``)
TINY_TRAFFIC = {"batch": 4, "pool": 8, "rate": 12.0, "max_wait_ms": 25.0,
                "warmup_seconds": 0.5}


def schedule(seed: int, salt: int, rate: float, seconds: float, pool: int,
             burst_period_s: float = 0.0, burst_duty: float = 1.0):
    """(offset s, pool index) of each arrival, in order: ``round(rate *
    seconds)`` arrivals whose gaps are the exponential distribution's
    quantiles at (k + 1/2) / n, scaled to fill the window, in an order drawn
    from the seed. Every seed sends the same gaps, in another order, so a
    seed changes where the bursts fall and not how many there are. With a
    ``burst_period_s``, arrivals come only in the first ``burst_duty`` of
    each period, at ``rate / burst_duty``: the same mean rate in bursts."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), salt])
    n = max(1, round(rate * seconds))
    on = seconds * (burst_duty if burst_period_s else 1.0)
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps) * (on / gaps.sum())
    offsets = np.concatenate(([0.0], np.cumsum(gaps)[:-1]))
    if burst_period_s:
        d = burst_period_s * burst_duty
        offsets = np.floor(offsets / d) * burst_period_s + np.mod(offsets, d)
    return list(zip(offsets.tolist(), rng.integers(0, pool, n).tolist()))


def traffic_schedule(tr: dict, seed: int, salt: int, seconds: float, pool: int):
    """``schedule`` with a traffic file's parameters."""
    return schedule(seed, salt, tr["rate"], seconds, pool, tr.get("burst_period_s", 0.0),
                    tr.get("burst_duty", 1.0))


def npz(entry) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **entry)
    return buf.getvalue()


class Submissions:
    """The batcher's queue order: each request id with its entry, in the
    order ``submit_many`` queued them (one lock around the batcher's own)."""

    def __init__(self, server):
        self.order, self._lock, self._tls = [], threading.Lock(), threading.local()
        batcher, handler = server.batcher, server.RequestHandlerClass
        submit, post = batcher.submit_many, handler.do_POST
        subs = self

        def submit_many(entries):
            with subs._lock:
                futures = submit(entries)
                subs.order += [(getattr(subs._tls, "rid", None), entry_key(e)) for e in entries]
            return futures

        def do_post(h):
            subs._tls.rid = int(h.headers.get("X-Request-Id", -1))
            post(h)

        batcher.submit_many, handler.do_POST = submit_many, do_post


def make_server(cell, w, seed, device, mode, model_path):
    import torch

    from pmhc_tpu_torch.cli.serve_cli import build_parser, create_server

    cfg, tr = cell.config, cell.traffic
    torch.save({k: v.cpu() for k, v in w.items()}, model_path)
    argv = [model_path, "--port", "0", "--batch-size", str(tr["batch"]),
            "-T", str(cfg["noise_step_count"]), "--backend", cfg["backend"],
            "--max-wait-ms", str(tr["max_wait_ms"]), "--seed", str(seed),
            "--device", str(device)]
    argv += {"bf16": ["--bf16"], "fast-f32": ["--fast-f32"]}.get(mode, [])
    return create_server(build_parser().parse_args(argv))


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        mode=None) -> Record:
    import torch

    dev = torch.device(device)
    mode = mode or cell.config["mode"]
    tr = cell.traffic
    B, T = tr["batch"], cell.config["noise_step_count"]
    rec = Record(cell)
    gen = LoadGenerator()
    w = ref.make_weights(seed, dev)
    pool = make_pool(tr["pool"], seed)
    entries = [request_entry(pool, i) for i in range(tr["pool"])]
    keys = {entry_key(e): i for i, e in enumerate(entries)}
    bodies = [npz(e) for e in entries]
    with tempfile.TemporaryDirectory() as tmp:
        server = make_server(cell, w, seed, dev, mode, os.path.join(tmp, "model.pth"))
    host, port = server.server_address[:2]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        service = server.batcher.service
        subs = Submissions(server)
        # the HTTP path and a part-filled batch; then the cell's own traffic
        # for ``warmup_seconds`` runs straight into the window, so that the
        # window opens on the pipeline in its steady state
        gen.run(host, port, [(0.0, i) for i in range(tr["warmup_requests"])], bodies,
                tr["drain_s"])
        chain = ChainTap(T).install()
        first = len(subs.order)
        W = tr["warmup_seconds"]
        lead = traffic_schedule(tr, seed, 5, W, len(bodies))
        load = lead + [(W + o, i) for o, i in traffic_schedule(tr, seed, 3, seconds, len(bodies))]
        n_lead = len(lead)
        # the checked batch: the one that holds a request drawn from the seed
        # among the first part of the window's
        target = n_lead + pick(seed, 1, max(1, int(seconds * tr["rate"] *
                                                    tr["check_within_first"])))[0]
        tap = ServiceTap(service, chain, lambda i, before, n: any(
            subs.order[first + j][0] == target for j in range(before, before + n)), rec.spans)
        start, records = gen.run(host, port, load, bodies, tr["drain_s"], lead_s=0.5)
        rec.setup_s = start + W - t0
        rec.window_s = seconds
        records = records[n_lead:]
        late = max(r[2] - r[1] for r in records)
        print(f"load generator: {len(records)} requests, latest send {late * 1e3:.1f} ms after "
              f"its due time", file=sys.stderr, flush=True)
        rec.latencies = [r[3] - r[1] if r[5] else math.inf for r in records]
        rec.attempted = len(records)
        rec.failed = sum(1 for r in records if not r[5])
        rec.completed = rec.attempted - rec.failed
        # the window's batches: those that hold a request due in it
        queued = subs.order[first:]
        texts, pos, window_batches, spans = {}, 0, [], {k: [] for k in rec.spans}
        for k, b in enumerate(tap.batches):
            ids = [rid for rid, _ in queued[pos:pos + b["n"]]]
            if [key for _, key in queued[pos:pos + b["n"]]] != b["keys"]:
                raise RuntimeError(f"batch {k}: the queue order does not match the dispatch")
            pos += b["n"]
            if max(ids) >= n_lead:
                window_batches.append(b)
                for name in spans:
                    spans[name].append(rec.spans[name][k])
            if target in ids:
                got = gen.bodies(ids)
                texts[k] = [got[i] for i in ids]
        rec.spans = spans
        rec.counters.update(batch=B, batches=len(window_batches),
                            rows=sum(b["n"] for b in window_batches))
        if trace:
            tracer = Tracer(dev)
            tracer.start()
            gen.run(host, port, traffic_schedule(tr, seed, 4, tr["trace_seconds"], len(bodies)),
                    bodies, tr["drain_s"])
            tracer.stop()
            rec.trace = tracer.trace
            rec.counters.update(busy_s=rec.trace.busy_s, trace_window_s=rec.trace.window_s)
        if dev.type == "cuda":
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        tap.remove()
        chain.uninstall()
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(30)
        gen.close()
    del server, service, tap.service
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.checks = check_batches(cell, w, pool, keys, tap, texts, dev)
    return rec
