"""The knee of a serving cell: one server, windows of open-loop load at a list
of rates, each printed as one JSON line: requests sent and answered, the
latency's median and 95th percentile, and whether the backlog grew (the
median latency of the window's last quarter of arrivals over its second
quarter's; near 1 when the server keeps up). The knee is the highest rate
whose backlog does not grow; the cell's rate is fixed below it, in its
traffic file. Not part of a benchmark run.

    python3 -m benchmark.sweep_serve --workload f32.serve.open --seed 5 --seconds 20 \\
        --rates 60,80,90,100,110
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import tempfile
import threading
from argparse import ArgumentParser


def main(argv=None) -> int:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="f32.serve.open")
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark.drivers.serve import make_server, npz, schedule
    from benchmark.inputs import make_pool, request_entry
    from benchmark.loadgen import LoadGenerator
    from benchmark.reference import model as ref
    from benchmark.run import cache_dirs

    cache_dirs(harness.ROOT)
    cell = harness.load_cell(args.workload)
    tr = cell.traffic
    gen = LoadGenerator()
    w = ref.make_weights(args.seed, "cuda")
    pool = make_pool(tr["pool"], args.seed)
    bodies = [npz(request_entry(pool, i)) for i in range(tr["pool"])]
    with tempfile.TemporaryDirectory() as tmp:
        server = make_server(cell, w, args.seed, "cuda", cell.config["mode"],
                             os.path.join(tmp, "model.pth"))
    host, port = server.server_address[:2]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    card = torch.cuda.get_device_name(0)
    try:
        gen.run(host, port, [(0.0, i) for i in range(tr["warmup_requests"])], bodies, tr["drain_s"])
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            batches0 = server.batcher.batches
            start, recs = gen.run(host, port,
                                  schedule(args.seed, 100 + k, rate, args.seconds, len(bodies)),
                                  bodies, tr["drain_s"])
            ok = [r for r in recs if r[5]]
            lat = sorted(r[3] - r[1] for r in ok) or [math.inf]
            q = len(recs) // 4
            second = statistics.median(r[3] - r[1] for r in recs[q:2 * q]) if q else math.nan
            last = statistics.median(r[3] - r[1] for r in recs[3 * q:]) if q else math.nan
            print(json.dumps({
                "rate": rate, "sent": len(recs), "answered": len(ok),
                "served_per_s": len(ok) / args.seconds, "p50_s": statistics.median(lat),
                "p95_s": lat[max(0, math.ceil(0.95 * len(lat)) - 1)],
                "backlog_growth": last / second, "batches": server.batcher.batches - batches0,
                "latest_send_ms": 1e3 * max(r[2] - r[1] for r in recs), "card": card}),
                flush=True)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(30)
        gen.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
