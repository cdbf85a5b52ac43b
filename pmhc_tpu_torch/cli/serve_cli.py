"""Serving CLI: a persistent sampling server on the card.

Counterpart of ``pmhc_tpu/cli/serve_cli.py``, with its flags, defaults and
HTTP contract. Keeps one sampler resident (``pmhc_tpu_torch.serve``) and
serves HTTP requests, micro-batching concurrent requests into its batch
shape:

- ``GET /healthz``: JSON service status and configuration (the JAX
  server's keys; ``precision`` is what the layers run at: ``"bf16"``,
  ``"fast-f32"`` or ``"f32"``; the ``pallas``, ``blockwise`` and ``xla``
  backends run fp32 whatever ``--bf16`` / ``--fast-f32`` ask), and
  ``counters``: the process's counters (``utils/profiling.py::counters``:
  ``serve.batches``, ``serve.padded_rows``, ``graphs.captures``,
  ``ops.builds`` and the kernels' launches).
- ``POST /sample``: body, an ``.npz`` archive with the single-complex entry
  arrays (``pmhc_tpu_torch.serve.ENTRY_SPECS``). Response: the sampled
  complex as PDB text (chains P and M). ``?samples=N`` returns N
  independent conformations as one multi-MODEL PDB, N up to
  ``--max-samples``.
- Errors: 400 for a bad ``samples`` value or body, 404 for other paths,
  503 with ``Retry-After: 1`` when ``--max-queue`` is reached, 500 when
  sampling fails.

Backends (``--backend``): ``auto`` / ``pallas_lane`` / ``g8``, the fused
kernel; ``pallas``, the round-1 fused kernel; ``blockwise``, the
online-softmax layer over neighbour blocks (plain PyTorch); ``xla``, the
dense layer.

``--aot FILE``: load the sampler artifact FILE (``pmhc_tpu_torch/aot.py``:
its kernel libraries and weights) before the warm-up if it exists, its
configuration checked against the flags; else save one after the warm-up,
so the next start loads it and builds nothing.

Run it (``--device cpu`` for a run without a card):

    python -m pmhc_tpu_torch.cli.serve_cli model.pth --backend pallas
    python -m pmhc_tpu_torch.cli.serve_cli model.pth --aot sampler.aot

Client example::

    buf = io.BytesIO(); np.savez(buf, **entry)
    conn = http.client.HTTPConnection(host, port)
    conn.request("POST", "/sample?samples=3", buf.getvalue())
    pdb_text = conn.getresponse().read()
"""

from __future__ import annotations

import io
import json
import logging
import os
import sys
from argparse import ArgumentParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_log = logging.getLogger(__name__)

MAX_BODY = 64 << 20
RESULT_TIMEOUT_S = 900.0


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__)
    p.add_argument("model", help="model weights: a reference-format .pth, or a directory of the "
                                 "port's checkpoints (train/checkpoints.py). The JAX package's "
                                 "orbax directories are not readable here")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks an ephemeral port (printed on startup)")
    p.add_argument("--batch-size", "-b", type=int, default=64,
                   help="the sampler's batch shape; concurrent requests are "
                        "micro-batched into it")
    p.add_argument("--max-wait-ms", type=float, default=25.0,
                   help="micro-batching window: dispatch when the batch "
                        "is full or the oldest request has waited this long")
    p.add_argument("--debug", "-d", action="store_true")
    p.add_argument("-T", type=int, default=1000, help="number of noise steps")
    p.add_argument("--sample-steps", type=int, default=None,
                   help="strided few-step sampling")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "xla", "pallas", "pallas_lane", "g8", "blockwise"),
                   help="auto / pallas_lane / g8: the fused kernel; pallas: the "
                        "round-1 fused kernel (fp32 only); blockwise: the online-softmax "
                        "layer over neighbour blocks (fp32); xla: the dense layer")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mode of the fused kernel (auto / pallas_lane / g8 only)")
    p.add_argument("--fast-f32", action="store_true",
                   help="high mode of the fused kernel: its products split into bf16 "
                        "hi/lo halves, ~1.5e-5 relative (auto / pallas_lane / g8 only; "
                        "--bf16 wins)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-samples", type=int, default=16,
                   help="cap on ?samples=N per request")
    p.add_argument("--max-queue", type=int, default=None,
                   help="bound on undispatched queued requests; beyond it "
                        "POST /sample returns 503 + Retry-After instead of "
                        "growing the backlog (default: 8x batch size; "
                        "0 = unbounded)")
    p.add_argument("--listen-backlog", type=int, default=128,
                   help="TCP listen(2) backlog. The http.server default "
                        "of 5 drops connections under bursty concurrent load")
    p.add_argument("--aot", default=None, metavar="FILE",
                   help="AOT sampler artifact (pmhc_tpu_torch.aot): load FILE if it exists "
                        "(its kernel libraries and weights, no build; the configuration must "
                        "match), else save it after warm-up so the next start loads it")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sampler (default: the card; "
                        "cpu runs the kernels' plain versions)")
    return p


def create_server(args) -> ThreadingHTTPServer:
    """Build the warm service and the HTTP server (separate from ``main``
    so tests can drive the server's lifecycle in-process)."""
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.serve import BatchingSampler, Overloaded, SamplerService, frame_models
    from pmhc_tpu_torch.utils.profiling import counters

    service = SamplerService(
        load_params(args.model),
        batch_size=args.batch_size,
        noise_step_count=args.T,
        num_steps=args.sample_steps,
        backend=args.backend,
        bf16=args.bf16,
        fast_f32=args.fast_f32,
        seed=args.seed,
        device=args.device,
    )
    if args.aot and os.path.exists(args.aot):
        from pmhc_tpu_torch.aot import load_sampler

        load_sampler(args.aot, service)
        _log.info("loaded AOT sampler artifact %s", args.aot)
    _log.info("backend %s, batch %d on %s: warming up (builds the kernels on first use)...",
              service.backend, service.batch_size, service.device)
    _log.info("warmup done in %.1fs", service.warmup())
    if args.aot and not os.path.exists(args.aot):
        from pmhc_tpu_torch.aot import save_sampler

        save_sampler(service, args.aot)
    max_queue = (8 * service.batch_size if args.max_queue is None
                 else args.max_queue or None)
    batcher = BatchingSampler(service, max_wait_ms=args.max_wait_ms, max_queue=max_queue)
    health = {
        "status": "ok",
        "backend": service.backend,
        "batch_size": service.batch_size,
        "noise_step_count": args.T,
        "sample_steps": args.sample_steps or args.T,
        "precision": service.precision,
        "max_queue": max_queue,
    }
    max_samples = args.max_samples

    class Handler(BaseHTTPRequestHandler):
        server_version = "pmhc-torch-serve/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # route through logging
            _log.debug("http: " + fmt, *a)

        def _reply(self, code: int, body: bytes, ctype: str, headers=()) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj, headers=()) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json", headers)

        def _refuse(self, code: int, obj) -> None:
            """An error before the body was read: close the connection,
            whose unread body would otherwise be parsed as the next request."""
            self.close_connection = True
            self._json(code, obj, headers=(("Connection", "close"),))

        def do_GET(self):  # noqa: N802 — http.server API
            if urlparse(self.path).path == "/healthz":
                self._json(200, {**health, "counters": counters()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/sample":
                self._refuse(404, {"error": "unknown path"})
                return
            try:
                n_samples = int(parse_qs(url.query).get("samples", ["1"])[0])
                if not 1 <= n_samples <= max_samples:
                    raise ValueError
            except ValueError:
                self._refuse(400, {"error": f"samples must be in [1, {max_samples}]"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= MAX_BODY:
                    raise ValueError
            except ValueError:
                self._refuse(400, {"error": "missing, malformed or oversized body"})
                return
            body = self.rfile.read(length)
            try:
                with np.load(io.BytesIO(body)) as z:
                    entry = {k: z[k] for k in z.files}
            except Exception as e:  # noqa: BLE001 — client error
                self._json(400, {"error": f"body is not a readable npz: {e}"})
                return
            try:
                futures = batcher.submit_many([entry] * n_samples)
            except Overloaded as e:
                self._json(503, {"error": str(e)}, headers=(("Retry-After", "1"),))
                return
            try:
                pdbs = [f.result(timeout=RESULT_TIMEOUT_S) for f in futures]
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — server error
                _log.exception("sampling failed")
                self._json(500, {"error": f"sampling failed: {e}"})
                return
            self._reply(200, frame_models(pdbs), "chemical/x-pdb")

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 resets connections
        # under bursty concurrent load
        request_queue_size = args.listen_backlog

    server = Server((args.host, args.port), Handler)
    server.batcher = batcher  # for tests and a clean shutdown
    return server


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=logging.DEBUG if args.debug else logging.INFO)
    server = create_server(args)
    _log.info("serving on http://%s:%d (POST /sample, GET /healthz)", *server.server_address)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
