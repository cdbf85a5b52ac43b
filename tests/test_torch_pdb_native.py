"""The port's native PDB formatter (``pmhc_tpu_torch/io/pdb_native.py`` on
its copy of ``csrc/pdb_formatter.cc``), mirroring
``tests/unit/test_pdb_native_formatter.py``: byte for byte the Python
formatter and the JAX package's ``pdb_native.format_atoms`` over random,
negative, large and rounding-edge coordinates; whole files equal on both
paths and still equal the reference fixtures; ``SamplerService.finalize``
takes the native path; a missing or failing g++ raises instead of falling
back to Python (the JAX package falls back)."""

import os

import numpy as np
import pytest
import torch

from pmhc_tpu.io import pdb_native as j_pdb_native
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.io import pdb_native
from pmhc_tpu_torch.io.pdb import _emit_atoms, _name_fields, pdb_bytes, save_pdb
from pmhc_tpu_torch.ops import _build
from pmhc_tpu_torch.serve import SamplerService, dummy_entry

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "fixtures")


def _random_fields(rng, n):
    names = ["N", "CA", "C", "O", "CB", "OXT", "CG1", "NE2", "OD1", "SD"]
    names4, elems2 = zip(*(_name_fields(names[i % len(names)]) for i in range(n)))
    res3 = np.frombuffer(b"GLYALAMETTRP", np.uint8).reshape(4, 3)
    # ordinary, negative, large and near-rounding-boundary coordinates
    coords = np.concatenate([
        rng.normal(0, 30, (n - 9, 3)),
        [[-999.9995, 0.0005, 12345.678],   # %8.3f width overflow
         [-0.0004, -0.0005, 0.0005],       # signed zero, half-even edges
         [99999.999, -99999.999, 1e-12],
         [0.12345, 1.99949999, 2.0005],
         [8.3335, -8.3335, 83.3335],
         [1 / 3, -2 / 3, 1e6 + 1 / 3],
         [np.float64(np.float32(3.14159)), np.float64(np.float32(-77.7)), 0],
         [1234.5675, -1234.5675, 0.9995],
         [1e300, -1e300, 1e-300]],         # wider than the first buffer
    ])
    return (np.stack(names4), res3[rng.integers(0, 4, n)], np.stack(elems2),
            rng.integers(1, 500, n).astype(np.int32), coords)


def test_native_matches_python_and_jax_bytes(monkeypatch):
    rng = np.random.default_rng(0)
    n = 400
    names4, res3, elems2, resseq, xyz = _random_fields(rng, n)
    pdb_native.reset_calls()
    native = _emit_atoms(7, "M", names4, res3, elems2, resseq, xyz)
    assert pdb_native.CALLS["format_atoms"] == 1
    monkeypatch.setenv("PMHC_PDB_FORMATTER", "python")
    python = _emit_atoms(7, "M", names4, res3, elems2, resseq, xyz)
    assert pdb_native.CALLS["format_atoms"] == 1
    assert native == python
    assert native.count(b"\n") == n
    serials = np.arange(8, 8 + n, dtype=np.int32)
    jax_bytes = j_pdb_native.format_atoms(serials, resseq, "M", names4, res3, elems2, xyz)
    if jax_bytes is None:  # the JAX formatter's buffer is fixed: its own Python path then
        monkeypatch.setenv("PMHC_PDB_FORMATTER", "python")
        from pmhc_tpu.io.pdb import _emit_atoms as j_emit

        jax_bytes = j_emit(7, "M", names4, res3, elems2, resseq, xyz)
    assert native == jax_bytes
    # and on ordinary coordinates the JAX library itself
    assert (pdb_native.format_atoms(serials[:50], resseq[:50], "P", names4[:50], res3[:50],
                                    elems2[:50], xyz[:50])
            == j_pdb_native.format_atoms(serials[:50], resseq[:50], "P", names4[:50], res3[:50],
                                         elems2[:50], xyz[:50]))


def test_format_atoms_checks_its_arrays():
    names4, res3, elems2, resseq, xyz = _random_fields(np.random.default_rng(1), 12)
    serials = np.arange(1, 13, dtype=np.int32)
    with pytest.raises(ValueError, match="xyz"):
        pdb_native.format_atoms(serials, resseq, "P", names4, res3, elems2, xyz[:5])
    with pytest.raises(ValueError, match="chain"):
        pdb_native.format_atoms(serials, resseq, "PM", names4, res3, elems2, xyz)
    assert pdb_native.format_atoms(serials[:0], resseq[:0], "P", names4[:0], res3[:0],
                                   elems2[:0], xyz[:0]) == b""


@pytest.mark.parametrize("formatter", ["native", "python"])
@pytest.mark.parametrize("index", [0, 1])
def test_save_pdb_writes_the_reference_fixtures(tmp_path, monkeypatch, formatter, index):
    if formatter == "python":
        monkeypatch.setenv("PMHC_PDB_FORMATTER", "python")
    data = dict(np.load(os.path.join(FIXTURES, "pdb_input.npz")))
    batch = {k: torch.from_numpy(v) for k, v in data.items() if k != "frames"}
    batch["frames"] = TRigid.from_tensor_7(torch.from_numpy(data["frames"]))
    path = str(tmp_path / "out.pdb")
    save_pdb(batch, index, path)
    with open(os.path.join(FIXTURES, f"reference_sample_{index}.pdb"), "rb") as f:
        assert open(path, "rb").read().splitlines() == f.read().splitlines()


def test_finalize_takes_the_native_path_and_equals_python(monkeypatch):
    from tests.test_torch_egnn import params_pair

    svc = SamplerService(params_pair(seed=4)[1], batch_size=3, noise_step_count=3, device="cpu")
    entries = [dummy_entry(protein_len=5 + i, seed=i) for i in range(3)]
    for e in entries:
        e["protein_atom14_exists"][:, :5] = True
    handle = svc.dispatch(entries, torch.Generator().manual_seed(2))
    pdb_native.reset_calls()
    native = svc.finalize(handle)
    assert pdb_native.CALLS["format_atoms"] == 2 * len(entries)  # chains P and M
    monkeypatch.setenv("PMHC_PDB_FORMATTER", "python")
    assert svc.finalize(handle) == native
    assert pdb_native.CALLS["format_atoms"] == 2 * len(entries)


def test_missing_gxx_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    data = dict(np.load(os.path.join(FIXTURES, "pdb_input.npz")))
    batch = {k: torch.from_numpy(v) for k, v in data.items() if k != "frames"}
    batch["frames"] = TRigid.from_tensor_7(torch.from_numpy(data["frames"]))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))  # nothing built here
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        pdb_bytes(batch, 0)
    monkeypatch.setenv("PMHC_PDB_FORMATTER", "python")  # asked for: the Python path
    assert pdb_bytes(batch, 0).endswith(b"END\n")


def test_failed_gxx_build_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "broken.cc").write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed \(1\)[\s\S]*broken\.cc"):
        _build.build("broken", src_dir=str(tmp_path))
    assert not os.listdir(tmp_path / "build")


def test_host_library_name_carries_its_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "hello.cc"
    src.write_text('extern "C" int hello() { return 7; }\n')
    first = _build.build("hello", src_dir=str(tmp_path))
    assert os.path.basename(first["path"]) == f"libhello-{_build.digest('hello', str(tmp_path))}.so"
    assert _build.build("hello", src_dir=str(tmp_path))["seconds"] == 0.0  # reused
    src.write_text('extern "C" int hello() { return 8; }\n')
    second = _build.build("hello", src_dir=str(tmp_path))
    assert second["path"] != first["path"] and second["seconds"] > 0.0
