"""The port's serving front end (``pmhc_tpu_torch.serve.BatchingSampler``,
``frame_models``, ``pmhc_tpu_torch.cli.serve_cli``) on the CPU, mirroring
``tests/e2e/test_serve.py``: a batch-4, T=6 service with the ``pallas``
backend (the kernel's plain version here), the HTTP server in-process on
port 0 with ``--device cpu``, and the JAX server's contract (``/healthz``
keys, PDB bodies, multi-MODEL ``?samples=N``, 400, 404, 503 with
``Retry-After``, a draining ``close()``)."""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from chip_smoke import request_entry
from pmhc_tpu.serve import frame_models as j_frame_models
from pmhc_tpu_torch.serve import (
    BatchingSampler,
    Overloaded,
    SamplerService,
    batch_seed,
    frame_models,
    validate_entry,
)
from tests.test_torch_egnn import params_pair

torch.set_num_threads(1)
T = 6


@pytest.fixture(scope="module")
def model():
    return params_pair(seed=6)[1]


@pytest.fixture(scope="module")
def service(model):
    svc = SamplerService(model, batch_size=4, noise_step_count=T, backend="pallas", seed=3,
                         device="cpu")
    svc.warmup()
    return svc


def entries(n, protein_len=12):
    """Request entries whose chain M atom counts differ with the seed."""
    return [request_entry(seed=i, protein_len=protein_len) for i in range(n)]


def _check_pdb(data: bytes, entry=None):
    text = data.decode()
    atom_lines = [ln for ln in text.splitlines() if ln.startswith("ATOM")]
    assert {ln[21] for ln in atom_lines} == {"P", "M"}
    coords = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atom_lines])
    assert np.isfinite(coords).all()
    assert text.rstrip().endswith("END")
    if entry is not None:
        assert sum(ln[21] == "M" for ln in atom_lines) == int(entry["protein_atom14_exists"].sum())
    return atom_lines


def test_sample_entries_deterministic(service):
    es = entries(2)
    a = service.sample_entries(es, torch.Generator().manual_seed(42))
    b = service.sample_entries(es, torch.Generator().manual_seed(42))
    assert len(a) == 2
    for pa, pb, e in zip(a, b, es):
        _check_pdb(pa, e)
        assert pa == pb  # same generator seed + same batch -> identical bytes


def test_sample_entries_partial_batch_padding(service):
    # 1 real entry in a batch-4 service: pad rows must not leak into the output
    e = entries(1)[0]
    out = service.sample_entries([e], torch.Generator().manual_seed(1))
    assert len(out) == 1
    _check_pdb(out[0], e)


def test_batching_sampler_concurrent(service):
    # 9 concurrent requests through a batch-4 service -> >= 3 batches; every
    # future resolves to the PDB of its own entry
    es = entries(3)
    batcher = BatchingSampler(service, max_wait_ms=10.0)
    try:
        futs = [batcher.submit(es[i % 3]) for i in range(9)]
        pdbs = [f.result(timeout=300) for f in futs]
    finally:
        batcher.close()
    assert batcher.batches >= 3
    for i, p in enumerate(pdbs):
        _check_pdb(p, es[i % 3])


def test_batch_generators_follow_the_seed_rule(service):
    """Batch k of the batcher samples with ``batch_generator(k)``: seed
    ``batch_seed(seed, k)``."""
    assert batch_seed(3, 5) == 3 * 2 ** 32 + 5 and batch_seed(-1, 0) == (2 ** 32 - 1) * 2 ** 32
    es = entries(2)
    batcher = BatchingSampler(service, max_wait_ms=200.0)
    try:
        got = [f.result(timeout=300) for f in batcher.submit_many(es)]
    finally:
        batcher.close()
    assert batcher.batches == 1
    assert got == service.sample_entries(es, service.batch_generator(0))


def test_batching_sampler_rejects_bad_entry(service):
    batcher = BatchingSampler(service, max_wait_ms=5.0)
    try:
        bad = entries(1)[0]
        bad.pop("pocket_frames")
        fut = batcher.submit(bad)
        with pytest.raises(ValueError, match="pocket_frames"):
            fut.result(timeout=10)
        # a bad entry must not poison the service for later requests
        good = entries(1)[0]
        _check_pdb(batcher.submit(good).result(timeout=300), good)
    finally:
        batcher.close()


def test_validate_entry_shape_error():
    e = entries(1)[0]
    e["frames"] = e["frames"][:, :6]
    with pytest.raises(ValueError, match="frames"):
        validate_entry(e)


def test_frame_models_bytes_equal_jax():
    for pdbs in ([b"ATOM x\nEND\n"], [b"ATOM a\nEND\n", b"ATOM b\nEND\n", b"ATOM c\n"]):
        assert frame_models(pdbs) == j_frame_models(pdbs)
    text = frame_models([b"ATOM a\nEND\n", b"ATOM b\nEND\n"]).decode()
    assert text.count("MODEL") == 2 and text.count("ENDMDL") == 2
    assert text.rstrip().endswith("END")


def _serve(args):
    from pmhc_tpu_torch.cli.serve_cli import create_server

    server = create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    thread.join(timeout=30)
    server.batcher.close()
    server.server_close()


def _jax_health_keys(monkeypatch):
    """The keys of the JAX server's ``/healthz``, from its own
    ``create_server`` with the sampler stubbed out (nothing compiles)."""
    import pmhc_tpu.serve as j_serve
    from pmhc_tpu.cli import serve_cli as j_cli

    class StubService:
        def __init__(self, params, **kw):
            self.backend, self.batch_size = kw["backend"], kw["batch_size"]

        def warmup(self):
            return 0.0

    monkeypatch.setattr(j_cli, "_load_params", lambda *a: None)
    monkeypatch.setattr(j_serve, "SamplerService", StubService)
    server = j_cli.create_server(j_cli.build_parser().parse_args(
        ["unused.pth", "--port", "0", "--backend", "xla"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection(*server.server_address, timeout=60)
        conn.request("GET", "/healthz")
        return set(json.loads(conn.getresponse().read()))
    finally:
        _stop(server, thread)


def _model_file(tmp_path, model):
    path = str(tmp_path / "serve_model.pth")
    torch.save(model.state_dict(), path)
    return path


def _npz(entry) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **entry)
    return buf.getvalue()


def test_http_server_end_to_end(tmp_path, model, monkeypatch):
    from pmhc_tpu_torch.cli.serve_cli import build_parser

    jax_keys = _jax_health_keys(monkeypatch)
    args = build_parser().parse_args([
        _model_file(tmp_path, model), "--port", "0", "--batch-size", "4", "-T", str(T),
        "--backend", "pallas", "--bf16", "--max-wait-ms", "5", "--max-samples", "4",
        "--device", "cpu"])
    server, thread = _serve(args)
    host, port = server.server_address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=300)

        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200
        assert set(health) == jax_keys | {"counters"}
        assert health["status"] == "ok" and health["batch_size"] == 4
        assert health["backend"] == "pallas"
        assert health["precision"] == "f32"  # --bf16 does not reach the pallas kernel
        assert health["max_queue"] == 32

        entry = entries(1)[0]
        body = _npz(entry)
        conn.request("POST", "/sample", body)
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200, data
        _check_pdb(data, entry)

        # multi-conformation: one multi-MODEL PDB
        conn.request("POST", "/sample?samples=3", body)
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200, data
        text = data.decode()
        assert text.count("MODEL") == 3 and text.count("ENDMDL") == 3

        # client errors -> 400, not a server fault
        for path, payload, word in (("/sample", b"not an npz", b"npz"),
                                    ("/sample?samples=0", body, b"samples"),
                                    ("/sample?samples=5", body, b"samples"),
                                    ("/sample?samples=x", body, b"samples")):
            conn.request("POST", path, payload)
            resp = conn.getresponse()
            assert resp.status == 400, path
            assert word in resp.read()
        bad = dict(entry)
        bad.pop("mask")
        conn.request("POST", "/sample", _npz(bad))
        resp = conn.getresponse()
        assert resp.status == 400
        assert b"mask" in resp.read()
        # a non-integer Content-Length -> 400 on a closed connection
        raw = http.client.HTTPConnection(host, port, timeout=60)
        raw.putrequest("POST", "/sample")
        raw.putheader("Content-Length", "12x")
        raw.endheaders()
        resp = raw.getresponse()
        assert resp.status == 400 and b"body" in resp.read()
        raw.close()

        # unknown paths -> 404
        conn.request("GET", "/sample")
        resp = conn.getresponse()
        assert resp.status == 404 and b"unknown path" in resp.read()
        conn.request("POST", "/healthz", body)
        resp = conn.getresponse()
        assert resp.status == 404 and b"unknown path" in resp.read()
        conn.request("GET", "/healthz")  # the connection survives the unread body
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["counters"]["serve.batches"] >= 2
        conn.close()
    finally:
        _stop(server, thread)


def test_http_503_on_overload(tmp_path, model):
    """--max-queue at the HTTP layer: a group larger than the bound is
    refused at once with 503 + Retry-After; under a flood every reply is 200
    or 503, and the accepted ones are PDBs."""
    from pmhc_tpu_torch.cli.serve_cli import build_parser

    args = build_parser().parse_args([
        _model_file(tmp_path, model), "--port", "0", "--batch-size", "4", "-T", str(T),
        "--backend", "pallas", "--max-wait-ms", "1", "--max-queue", "2", "--device", "cpu"])
    server, thread = _serve(args)
    host, port = server.server_address
    try:
        body = _npz(entries(1)[0])
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["max_queue"] == 2
        conn.request("POST", "/sample?samples=3", body)
        resp = conn.getresponse()
        assert resp.status == 503 and resp.getheader("Retry-After") == "1"
        assert b"max_queue=2" in resp.read()
        conn.close()

        statuses = []
        lock = threading.Lock()

        def client():
            c = http.client.HTTPConnection(host, port, timeout=300)
            c.request("POST", "/sample", body)
            r = c.getresponse()
            data = r.read()
            with lock:
                statuses.append((r.status, r.getheader("Retry-After")))
            if r.status == 200:
                _check_pdb(data)
            c.close()

        threads = [threading.Thread(target=client) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        codes = [s for s, _ in statuses]
        assert len(codes) == 12 and set(codes) <= {200, 503} and 200 in codes
        assert all(retry == "1" for status, retry in statuses if status == 503)
    finally:
        _stop(server, thread)


def test_overloaded_batcher_bounds_its_queue(service):
    batcher = BatchingSampler(service, max_wait_ms=1.0, max_queue=4)
    try:
        entry = entries(1)[0]
        accepted, rejected = [], 0
        for _ in range(32):
            try:
                accepted.append(batcher.submit(entry))
            except Overloaded:
                rejected += 1
            assert batcher._q.qsize() <= 4
        with pytest.raises(Overloaded):
            batcher.submit_many([entry] * 5)  # all or none: larger than the bound
        assert accepted
        for fut in accepted:
            _check_pdb(fut.result(timeout=300), entry)
    finally:
        batcher.close()


def test_close_resolves_all_queued_futures(service):
    """close() with a queued backlog drains it: every accepted future is
    resolved, none left hanging; submitting after close is a clean error."""
    batcher = BatchingSampler(service, max_wait_ms=1000.0)
    entry = entries(1)[0]
    futures = [batcher.submit(entry) for _ in range(7)]
    batcher.close()
    for fut in futures:
        assert fut.done(), "close() left a queued future unresolved"
        _check_pdb(fut.result(timeout=0), entry)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(entry)
