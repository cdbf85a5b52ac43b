"""Data pipeline: SwiftMHC-format HDF5 (or its packed ``.npz``) ->
fixed-shape batches. h5py is imported only where an HDF5 file is read or
written."""

from pmhc_tpu_torch.data.dataset import PmhcDataset
from pmhc_tpu_torch.data.loader import PrefetchLoader
from pmhc_tpu_torch.data.packed import DeviceDataset, PackedDataset
from pmhc_tpu_torch.data.realistic import write_realistic_hdf5
from pmhc_tpu_torch.data.synthetic import (
    PEPTIDE_MAXLEN,
    POCKET_MAXLEN,
    synthetic_batch,
    write_synthetic_hdf5,
)

__all__ = [
    "PmhcDataset",
    "PackedDataset",
    "DeviceDataset",
    "PrefetchLoader",
    "PEPTIDE_MAXLEN",
    "POCKET_MAXLEN",
    "synthetic_batch",
    "write_synthetic_hdf5",
    "write_realistic_hdf5",
]
