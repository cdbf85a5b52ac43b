"""The port's native HDF5 decoder (``pmhc_tpu_torch/data/native.py`` on its
copy of ``csrc/hdf5_decoder.cc``), mirroring
``tests/unit/test_native_decoder.py``: bit for bit the port's
``PmhcDataset.get_entry`` and the JAX package's ``decode_packed`` on files
that the synthetic and the realistic writers wrote; ``PackedDataset``
decodes through it; it is unavailable only where no libhdf5 (h5py) is; a
failed build raises."""

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


@pytest.mark.parametrize("writer", [write_synthetic_hdf5, write_realistic_hdf5])
def test_native_decoder_bit_exact(tmp_path, writer):
    h5 = str(tmp_path / "t.hdf5")
    writer(h5, n_entries=6, peptide_lengths=(8, 9, 10, 11), seed=3)
    ds = PmhcDataset(h5)
    assert native.is_available()
    out = native.decode_packed(h5, ds.entry_names)
    jax_out = j_native.decode_packed(h5, ds.entry_names)
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
