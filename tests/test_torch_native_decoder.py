"""The port's native HDF5 decoder (``pmhc_tpu_torch/data/native.py`` on its
copy of ``csrc/hdf5_decoder.cc``), mirroring
``tests/unit/test_native_decoder.py``: bit for bit the port's
``PmhcDataset.get_entry`` and the JAX package's ``decode_packed`` on files
that the synthetic and the realistic writers wrote; ``PackedDataset``
decodes through it; it is unavailable only where no libhdf5 (h5py) is; a
failed build raises.

The JAX package's decoder builds its library in place
(``csrc/build/libpmhc_decoder.so``) with no lock, and a process that fails
once to build or load it keeps failing (``ImportError("native decoder
unavailable")``). Under pytest-xdist every worker evaluates
``tests/unit/test_native_decoder.py``'s ``skipif(not
native.is_available())`` while it collects, so on a fresh checkout six
workers build that file at once, and a worker that loads it while another
rewrites it fails (``OSError: ... file too short``). The reference here
is therefore built once into the port's build directory, behind a file
lock, and loaded afresh in this process (``jax_decoder``)."""

import fcntl
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from pmhc_tpu.data import native as j_native
from pmhc_tpu_torch.data import (
    PackedDataset,
    PmhcDataset,
    native,
    write_realistic_hdf5,
    write_synthetic_hdf5,
)
from pmhc_tpu_torch.data.packed import _BATCH_KEYS
from pmhc_tpu_torch.ops import _build

torch.set_num_threads(1)


@pytest.fixture
def jax_decoder(monkeypatch):
    """The JAX package's ``decode_packed`` on a library of its own: its
    ``csrc/hdf5_decoder.cc`` built (once, under a file lock) into the
    port's build directory, named by the source's hash, and loaded in this
    process whatever an earlier load attempt left behind."""
    with open(j_native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, f"libpmhc_decoder-reference-{digest}.so")
    monkeypatch.setattr(j_native, "_LIB", lib)
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_failed", False)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            assert j_native._load() is not None, "the JAX package's native decoder did not build or load"
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return j_native.decode_packed


@pytest.mark.parametrize("writer", [write_synthetic_hdf5, write_realistic_hdf5])
def test_native_decoder_bit_exact(tmp_path, writer, jax_decoder):
    h5 = str(tmp_path / "t.hdf5")
    writer(h5, n_entries=6, peptide_lengths=(8, 9, 10, 11), seed=3)
    ds = PmhcDataset(h5)
    assert native.is_available()
    out = native.decode_packed(h5, ds.entry_names)
    jax_out = jax_decoder(h5, ds.entry_names)
    for k in _BATCH_KEYS:
        want = np.stack([ds.get_entry(n)[k] for n in ds.entry_names])
        assert out[k].dtype == want.dtype, (k, out[k].dtype, want.dtype)
        np.testing.assert_array_equal(out[k], want, err_msg=k)
        np.testing.assert_array_equal(out[k], jax_out[k], err_msg=k)


def test_packed_dataset_uses_native(tmp_path, monkeypatch):
    h5 = str(tmp_path / "t.hdf5")
    write_synthetic_hdf5(h5, n_entries=5, peptide_lengths=(9, 12), seed=1)
    calls = []
    decode = native.decode_packed
    monkeypatch.setattr(native, "decode_packed", lambda *a: calls.append(a) or decode(*a))
    packed = PackedDataset(h5)
    assert calls == [(h5, packed.entry_names)]
    ds = PmhcDataset(h5)
    for k in _BATCH_KEYS:
        want = np.stack([ds.get_entry(n)[k] for n in packed.entry_names])
        np.testing.assert_array_equal(packed._data[k], want, err_msg=k)
    batch = packed.get_batch([1, 3])
    assert batch["frames"].shape == (2, 16, 7)
    assert batch["name"] == [packed.entry_names[1], packed.entry_names[3]]


def test_unavailable_only_without_libhdf5(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert native._find_libhdf5() is None
    assert not native.is_available()
    with pytest.raises(ImportError, match="no libhdf5"):
        native.decode_packed(str(tmp_path / "t.hdf5"), ["a"])


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_started", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))  # nothing built here
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        native.is_available()


def test_decode_failure_names_the_entry(tmp_path):
    h5 = str(tmp_path / "t.hdf5")
    write_synthetic_hdf5(h5, n_entries=2, seed=0)
    with pytest.raises(RuntimeError, match="native HDF5 decode"):
        native.decode_packed(h5, ["no such entry"])
