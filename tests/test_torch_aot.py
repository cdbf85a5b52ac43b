"""The port's AOT sampler artifacts (``pmhc_tpu_torch/aot.py``) on the CPU,
mirroring ``tests/unit/test_aot.py``: both formats round-trip bit for bit
(the ``dense`` backend and the ``fused`` one, whose CPU path is the
kernel's plain version), torch-version and device-name drift, a
configuration mismatch and a file that is not an artifact are refused at
load with the JAX messages. Beyond the JAX tests: an artifact that carries
a library (the fused kernel compiled for the CPU against the CUDA
emulation, ``ops/_emulate.py``) is refused as not built from the package's
sources, and, with the package's digest pinned to the emulated build's,
loads with nvcc out of reach and launches equal to the plain version
(``chip_smoke.TOL``); a library of edited sources is refused in both
formats; a second library under one name is refused;
``serve_cli --aot`` saves, then loads and answers with the same bytes; and
an AOT-loaded service samples as JAX's ``SamplerService`` does on injected
noise (the sampler tolerances of ``tests/test_torch_sampler.py``: quats
2e-4, translations 1e-3, torsions 2e-4; atom14 1e-3, the translations'
tolerance, as ``tests/test_torch_serve.py`` holds atom14 at 1e-4 for one
conversion).
"""

import http.client
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.diffusion import sample as j_sample
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.io.pdb import convert_batch_for_pdb as j_convert
from pmhc_tpu.serve import SamplerService as JSamplerService
from pmhc_tpu_torch import aot
from pmhc_tpu_torch.aot import MAGIC, MAGIC_XC, load_sampler, read_artifact, save_sampler
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.io.pdb import convert_batch_for_pdb
from pmhc_tpu_torch.ops import _build, _emulate
from pmhc_tpu_torch.ops import egnn_fused as ef
from pmhc_tpu_torch.serve import SamplerService, dummy_entry
from pmhc_tpu_torch.tools.bench_aot import doctor
from tests.test_torch_egnn import params_pair
from tests.test_torch_sampler import _noise_np

torch.set_num_threads(1)
T = 5


@pytest.fixture(scope="module")
def model():
    return params_pair(seed=2)[1]


def _service(model, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("noise_step_count", T)
    kw.setdefault("backend", "dense")
    return SamplerService(model, device="cpu", **kw)


def _doctor(path, **changes):
    doctor(path, path, **changes)


@pytest.mark.parametrize("backend", ["dense", "fused"])
@pytest.mark.parametrize("fmt", ["executable", "stablehlo"])
def test_aot_roundtrip_bit_identical(tmp_path, model, fmt, backend):
    svc = _service(model, backend=backend)
    entries = [dummy_entry(), dummy_entry(seed=1)]
    want = svc.sample_entries(entries, torch.Generator().manual_seed(9))

    path = str(tmp_path / "sampler.aot")
    save_sampler(svc, path, fmt=fmt)
    magic, meta, _ = read_artifact(path)
    assert magic == (MAGIC_XC if fmt == "executable" else MAGIC)
    assert meta["platform"] == "cpu" and meta["backend"] == svc.backend
    assert "CUDA graphs are not serialised" in meta["graphs"]

    # a fresh service with other weights: the artifact's weights run
    fresh = _service(params_pair(seed=7)[1], backend=backend)
    run = load_sampler(path, fresh)
    assert run == fresh.sample_model_batch
    assert fresh.sample_entries(entries, torch.Generator().manual_seed(9)) == want
    # and without a service: one built from the header
    alone = load_sampler(path).__self__
    assert (alone.backend, alone.batch_size, alone.num_steps) == (svc.backend, 2, None)
    assert alone.sample_entries(entries, torch.Generator().manual_seed(9)) == want


@pytest.mark.parametrize("fmt", ["executable", "stablehlo"])
def test_aot_torch_version_drift(tmp_path, model, fmt, caplog):
    """The executable format is pinned to the exporting torch: a drifted
    artifact fails at load. The portable one logs a warning and loads."""
    path = str(tmp_path / "sampler.aot")
    save_sampler(_service(model), path, fmt=fmt)
    _doctor(path, torch_version="0.0.1")
    if fmt == "executable":
        with pytest.raises(ValueError, match="cannot load under"):
            load_sampler(path, _service(model))
    else:
        with caplog.at_level(logging.WARNING, logger="pmhc_tpu_torch.aot"):
            load_sampler(path, _service(model))
        assert "0.0.1" in caplog.text


def test_aot_device_name_drift_rejected(tmp_path, model):
    path = str(tmp_path / "sampler.aot")
    save_sampler(_service(model), path)
    _doctor(path, device_name="NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError, match="cannot load under"):
        load_sampler(path, _service(model))
    _doctor(path, device_name="cpu", platform="cuda")
    with pytest.raises(ValueError, match="platform 'cuda'"):
        load_sampler(path, _service(model))


def test_aot_config_mismatch_rejected(tmp_path, model):
    path = str(tmp_path / "sampler.aot")
    save_sampler(_service(model), path)
    with pytest.raises(ValueError, match="batch_size"):
        load_sampler(path, _service(model, batch_size=3))
    with pytest.raises(ValueError, match="num_steps"):
        load_sampler(path, _service(model, num_steps=2))
    with pytest.raises(ValueError, match="backend"):
        load_sampler(path, _service(model, backend="pallas"))


def test_aot_bad_file_rejected(tmp_path, model):
    path = tmp_path / "junk.aot"
    path.write_bytes(b"definitely not an artifact")
    with pytest.raises(ValueError, match="not a pmhc AOT artifact"):
        load_sampler(str(path))
    good = str(tmp_path / "sampler.aot")
    save_sampler(_service(model), good)
    data = open(good, "rb").read()
    path.write_bytes(data[:-10])
    with pytest.raises(ValueError, match="damaged"):
        load_sampler(str(path))


def test_aot_carries_a_library_and_loads_it_without_nvcc(tmp_path, model, monkeypatch):
    """An artifact of a process that runs the fused kernel (here compiled
    for the CPU against the CUDA emulation) carries its library; a fresh
    process state loads it with nvcc out of reach and launches it."""
    if _emulate.gxx_path() is None:
        pytest.skip("needs g++ to compile the kernel for the CPU")
    from chip_smoke import TOL, layer_case, random_model

    monkeypatch.setattr(_build, "_LIBS", {})
    emulated = _emulate.build_emulated("egnn_fused")._name
    _build.install("egnn_fused", emulated)
    path = str(tmp_path / "sampler.aot")
    save_sampler(_service(model, backend="fused"), path)
    _, meta, _ = read_artifact(path)
    assert {lib["name"] for lib in meta["libraries"]} == {"egnn_fused", "pdb_formatter"}

    monkeypatch.setattr(_build, "_LIBS", {})  # a fresh process

    def no_nvcc():
        raise RuntimeError("nvcc called")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    # the emulated build is not what this package's sources give: refused
    with pytest.raises(ValueError, match="cannot load under"):
        load_sampler(path, _service(model, backend="fused"))
    assert _build.loaded("egnn_fused") is None
    # a package whose egnn_fused is the emulated build loads it
    real_digest, emulated_digest = _build.digest, meta["libraries"][0]["digest"]
    assert emulated_digest.startswith("emu-")
    monkeypatch.setattr(_build, "digest", lambda name, src_dir=_build.CSRC: (
        emulated_digest if (name, src_dir) == ("egnn_fused", _build.CSRC)
        else real_digest(name, src_dir)))
    load_sampler(path, _service(model, backend="fused"))
    assert _build.loaded("egnn_fused").digest == meta["libraries"][0]["digest"]
    args = layer_case(random_model(seed=0), "gnn2", seed=3, device=torch.device("cpu"),
                      batch_size=1)
    got = ef.launch(ef._lib(), *args, bf16=False)
    want = ef.egnn_fused_plain(*args, bf16=False)
    for name, g, w in zip(("q", "t", "tors", "feat"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL["fp32"][name], err_msg=name)


@pytest.mark.parametrize("fmt", ["executable", "stablehlo"])
def test_aot_library_of_other_sources_refused(tmp_path, model, fmt, monkeypatch):
    """A library built from sources other than the running package's (a
    source edited since the export; the header stays consistent) is refused
    at load, before anything is installed: the package's wrappers bind the
    library's arguments."""
    path = str(tmp_path / "sampler.aot")
    save_sampler(_service(model), path, fmt=fmt)
    magic, meta, blobs = read_artifact(path)
    order = [key for key, _ in meta["blobs"]]
    if fmt == "executable":
        lib = meta["libraries"][0]
        old = "lib/" + lib["file"]
        lib["digest"] = "0" * 12
        lib["file"] = f"lib{lib['name']}-{lib['digest']}.so"
        order[order.index(old)] = "lib/" + lib["file"]
        blobs["lib/" + lib["file"]] = blobs.pop(old)
    else:
        src = meta["sources"][0]
        edited = tmp_path / "edited"
        edited.mkdir()
        for f in src["files"]:
            key = f"src/{src['name']}/{f}"
            blobs[key] += b"\n// edited after the export\n"
            (edited / f).write_bytes(blobs[key])
        src["digest"] = _build.digest(src["name"], str(edited))
    with open(path, "wb") as f:
        f.write(aot._pack(magic, meta, [(key, blobs[key]) for key in order]))
    service = _service(model)
    monkeypatch.setattr(_build, "_LIBS", {})  # a fresh process
    with pytest.raises(ValueError, match="cannot load under this package"):
        load_sampler(path, service)
    assert _build.loaded("pdb_formatter") is None


def test_second_library_under_one_name_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {})
    lib = _build.load("pdb_formatter")
    assert _build.install("pdb_formatter", _build.loaded("pdb_formatter").path) is lib
    other = tmp_path / "libpdb_formatter-000000000000.so"
    other.write_bytes(b"")
    with pytest.raises(RuntimeError, match="already loaded"):
        _build.install("pdb_formatter", str(other))
    with pytest.raises(ValueError, match="not a library"):
        _build.install("pdb_formatter", str(tmp_path / "libother-1.so"))


def test_serve_cli_aot_saves_then_loads(tmp_path, model, caplog):
    from pmhc_tpu_torch.cli.serve_cli import build_parser
    from tests.test_torch_serve_cli import _npz, _serve, _stop

    pth = str(tmp_path / "model.pth")
    torch.save(model.state_dict(), pth)
    artifact = tmp_path / "sampler.aot"
    flags = [pth, "--port", "0", "-T", "4", "--batch-size", "2", "--max-wait-ms", "5",
             "--device", "cpu", "--aot", str(artifact)]
    bodies = []
    for run in range(2):
        with caplog.at_level(logging.INFO):
            server, thread = _serve(build_parser().parse_args(flags))
        try:
            assert artifact.exists()
            conn = http.client.HTTPConnection(*server.server_address, timeout=300)
            conn.request("POST", "/sample", _npz(dummy_entry()))
            resp = conn.getresponse()
            assert resp.status == 200
            bodies.append(resp.read())
            conn.request("GET", "/healthz")
            assert json.loads(conn.getresponse().read())["status"] == "ok"
        finally:
            _stop(server, thread)
        assert ("loaded AOT sampler artifact" in caplog.text) == (run == 1)
        caplog.clear()
    assert bodies[0] == bodies[1]
    # other weights on the command line: the artifact's run, and it is logged
    torch.save(params_pair(seed=8)[1].state_dict(), pth)
    with caplog.at_level(logging.WARNING, logger="pmhc_tpu_torch.aot"):
        server, thread = _serve(build_parser().parse_args(flags))
    try:
        assert "weights differ from the artifact's" in caplog.text
        conn = http.client.HTTPConnection(*server.server_address, timeout=300)
        conn.request("POST", "/sample", _npz(dummy_entry()))
        assert conn.getresponse().read() == bodies[0]
    finally:
        _stop(server, thread)


def test_aot_loaded_service_matches_jax_service(tmp_path):
    """An AOT-loaded service's chain on injected noise against JAX's
    ``SamplerService`` (``xla``: the generic sampler) on the same weights,
    start state and noise."""
    params, model = params_pair(seed=3)
    B = 2
    path = str(tmp_path / "sampler.aot")
    save_sampler(_service(model, batch_size=B), path)
    run = load_sampler(path, _service(params_pair(seed=9)[1], batch_size=B))
    svc = run.__self__

    j_svc = JSamplerService(params, batch_size=B, noise_step_count=T, backend="xla")
    rng = np.random.default_rng(4)
    q0, t0, tor0 = (x[0] for x in _noise_np(rng, 1, B))
    q, t, tor = _noise_np(rng, T, B)
    entries = [dummy_entry(), dummy_entry(seed=1)]
    j_mb, _, _ = j_svc.build_model_batch(entries, jax.random.key(0))
    j_mb["frames"] = JRigid(jnp.asarray(q0), jnp.asarray(t0))
    j_mb["torsions"] = jnp.asarray(tor0)
    j_out = j_sample(j_svc.params, j_mb, jax.random.key(0), j_svc.diffusion_config,
                     j_svc.model_config, j_svc.tables, precision=j_svc.precision,
                     injected_noise={"frames": JRigid(jnp.asarray(q), jnp.asarray(t)),
                                     "torsions": jnp.asarray(tor)})
    mb, protein = svc.build_model_batch(entries, torch.Generator())
    mb["frames"] = TRigid(torch.from_numpy(q0), torch.from_numpy(t0))
    mb["torsions"] = torch.from_numpy(tor0)
    out = run(mb, torch.Generator(), injected_noise={
        "frames": TRigid(torch.from_numpy(q), torch.from_numpy(t)),
        "torsions": torch.from_numpy(tor)})
    np.testing.assert_allclose(out["frames"].quats.numpy(), np.asarray(j_out["frames"].quats),
                               atol=2e-4)
    np.testing.assert_allclose(out["frames"].trans.numpy(), np.asarray(j_out["frames"].trans),
                               atol=1e-3)
    np.testing.assert_allclose(out["torsions"].numpy(), np.asarray(j_out["torsions"]), atol=2e-4)
    j_pred = dict(j_out)
    j_pred.update({k: jnp.asarray(v) for k, v in protein.items()})
    pred = dict(out)
    pred.update(protein)
    np.testing.assert_allclose(convert_batch_for_pdb(pred)["atom14"].numpy(),
                               np.asarray(j_convert(j_pred)["atom14"]), atol=1e-3)


def test_weights_sha256_ignores_the_container(model):
    sd = model.state_dict()
    assert aot.weights_sha256(sd) == aot.weights_sha256({k: v.numpy() for k, v in sd.items()})
    other = dict(sd)
    other["gnn1.feature_mlp.0.bias"] = sd["gnn1.feature_mlp.0.bias"] + 1
    assert aot.weights_sha256(other) != aot.weights_sha256(sd)


def test_bench_aot_arms_on_the_cpu():
    """``tools/bench_aot.py``'s bench mode on the CPU: the export, then fresh
    processes on copies of the package, each bit-identical to the export
    (checked in the child), the AOT one with nvcc out of reach, and the
    doctored artifact refused before sampling."""
    from pmhc_tpu_torch.tools import bench_aot

    rows = bench_aot.main(["-b", "2", "-T", "3", "--device", "cpu",
                           "--arms", "cold,warm,aot,mismatch"])
    assert [r["arm"] for r in rows] == ["export", "cold", "warm", "aot", "mismatch"]
    for r in rows[1:4]:
        assert r["bit_identical"] and r["first_result_s"] > 0 and r["process_s"] > 0
        assert r["launches"]["pdb_native"]["format_atoms"] == 2 * 2  # chains P and M
        assert r["libraries"] == {"pdb_formatter": _build.digest("pdb_formatter")}
    assert rows[3]["nvcc"] is None
    assert "cannot load under" in rows[4]["refused"]
    with pytest.raises(SystemExit, match="unknown arms"):
        bench_aot.main(["--arms", "cold,hot", "--device", "cpu"])
