"""Packed (decode-once) datasets and their file form.

Counterpart of ``pmhc_tpu/data/packed.py``:

- ``PackedDataset`` decodes every entry once and keeps each padded field
  stacked in one numpy array; ``get_batch(indices)`` returns a collated
  batch by fancy indexing (the loader's fast path). The decode is pure
  Python: a process pool (spawn) above 10,000 entries, else in-process.
- ``DeviceDataset``: the packed arrays resident on a torch device, batches
  gathered there with ``index_select``; only the index vector crosses to
  the device per batch.

The file form is the input of a machine without HDF5: one uncompressed
``.npz`` holding the twelve ``_BATCH_KEYS`` stacks in entry order,
``name`` (the entry names, in the HDF5 file's key order), ``protein_len``
[E] and the full proteins (``protein_aatype``, ``protein_atom14_positions``,
``protein_atom14_exists``) zero-padded to the file's longest.
``PackedDataset.load`` reads it with numpy alone. Pack an HDF5 file where
h5py exists with

    python -m pmhc_tpu_torch.data.packed in.hdf5 out.npz
"""

from __future__ import annotations

import sys
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from pmhc_tpu_torch.data.dataset import (
    PEPTIDE_MAXLEN,
    POCKET_MAXLEN,
    PROTEIN_KEYS,
    PmhcDataset,
    stack_proteins,
)

_BATCH_KEYS = (
    "mask", "frames", "features", "aatype", "torsions", "torsions_mask",
    "pocket_aatype", "pocket_features", "pocket_mask", "pocket_frames",
    "pocket_atom14_positions", "pocket_atom14_exists",
)
PACK_COMMAND = "python -m pmhc_tpu_torch.data.packed in.hdf5 out.npz"


def _stack(entries: Sequence[Mapping]) -> Dict[str, np.ndarray]:
    return {k: np.stack([e[k] for e in entries]) for k in _BATCH_KEYS}


def _decode_shard(args):
    path, names = args
    ds = PmhcDataset(path)
    return [ds.get_entry(n) for n in names]


class _PackedProteins:
    """The full proteins of a packed file: padded to the file's longest,
    cut back to the longest of the names asked for."""

    def __init__(self, arrays: Mapping[str, np.ndarray], entry_names: Sequence[str]):
        self.arrays = dict(arrays)
        self._index = {n: i for i, n in enumerate(entry_names)}

    @classmethod
    def from_list(cls, proteins, entry_names):
        stacked = stack_proteins(proteins)
        stacked["protein_len"] = np.array([p["protein_aatype"].shape[0] for p in proteins],
                                          np.int32)
        return cls(stacked, entry_names)

    def get_protein_positions(self, entry_names: List[str]) -> Dict[str, np.ndarray]:
        idx = np.array([self._index[n] for n in entry_names])
        max_len = int(self.arrays["protein_len"][idx].max())
        # rows are zero past their own length, so a cut at the batch's
        # longest equals each row cut to its length and padded again
        return {k: self.arrays[k][idx, :max_len] for k in PROTEIN_KEYS}


class PackedDataset:
    """Decode-once, RAM-resident view of a SwiftMHC HDF5 file (or of a
    packed ``.npz``: :meth:`load`)."""

    peptide_maxlen = PEPTIDE_MAXLEN
    pocket_maxlen = POCKET_MAXLEN

    def __init__(self, hdf5_path: str, num_workers: int = 8):
        base = PmhcDataset(hdf5_path)
        self.entry_names: List[str] = list(base.entry_names)
        n = len(self.entry_names)
        if num_workers > 1 and n >= 10_000:
            # one HDF5 handle per process: decode scales past libhdf5's
            # in-process global lock; the child start-up only pays off on
            # large files, hence the threshold
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            shards = [(hdf5_path, self.entry_names[i::num_workers]) for i in range(num_workers)]
            with ProcessPoolExecutor(num_workers, mp_context=mp.get_context("spawn")) as pool:
                results = list(pool.map(_decode_shard, shards))
            entries: List[Dict] = [None] * n
            for i, shard in enumerate(results):
                entries[i::num_workers] = shard
        else:
            entries = [base.get_entry(name) for name in self.entry_names]
        self._set(_stack(entries), base)

    def _set(self, data: Dict[str, np.ndarray], proteins) -> None:
        self._data = data
        self._proteins = proteins  # anything with get_protein_positions
        self.nbytes = sum(v.nbytes for v in self._data.values())

    @classmethod
    def from_entries(cls, entries: Sequence[Mapping], proteins: Sequence[Mapping]) -> "PackedDataset":
        """A packed dataset from ``pad_entry`` results (with ``name``) and the
        matching ``protein_arrays`` results, in entry order."""
        self = cls.__new__(cls)
        self.entry_names = [e["name"] for e in entries]
        self._set(_stack(entries), _PackedProteins.from_list(proteins, self.entry_names))
        return self

    @classmethod
    def load(cls, path: str) -> "PackedDataset":
        """Read a packed ``.npz`` (numpy only: no h5py)."""
        with np.load(path, allow_pickle=False) as f:
            arrays = {k: f[k] for k in f.files}
        self = cls.__new__(cls)
        self.entry_names = [str(n) for n in arrays.pop("name")]
        proteins = {k: arrays.pop(k) for k in PROTEIN_KEYS + ("protein_len",)}
        self._set({k: arrays[k] for k in _BATCH_KEYS}, _PackedProteins(proteins, self.entry_names))
        return self

    def save(self, path: str) -> None:
        """Write the packed ``.npz`` (uncompressed) to ``path``."""
        if not path.endswith(".npz"):
            raise ValueError(f"{path}: a packed file ends in .npz")
        proteins = self._proteins
        if not isinstance(proteins, _PackedProteins):  # read from the HDF5 file
            proteins = _PackedProteins.from_list(
                [proteins.get_protein(n) for n in self.entry_names], self.entry_names)
        np.savez(path, name=np.array(self.entry_names), **self._data, **proteins.arrays)

    def __len__(self) -> int:
        return len(self.entry_names)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        out = {k: v[index] for k, v in self._data.items()}
        out["name"] = self.entry_names[index]
        return out

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Collated batch by fancy indexing: no per-entry work."""
        idx = np.asarray(indices)
        out = {k: v[idx] for k, v in self._data.items()}
        out["name"] = [self.entry_names[i] for i in indices]
        return out

    def get_protein_positions(self, entry_names: List[str]) -> Dict[str, np.ndarray]:
        """Full-protein arrays of ``entry_names``, padded to the longest of them."""
        return self._proteins.get_protein_positions(entry_names)


class DeviceDataset:
    """The packed dataset resident on ``device``, batches gathered there.

    The same ``get_batch`` protocol as ``PackedDataset`` (tensors on the
    device; names stay on the host), so the loader's fast path takes it
    unchanged and copies nothing.
    """

    def __init__(self, packed: PackedDataset, device):
        self.device = torch.device(device)
        self.entry_names = packed.entry_names
        self.peptide_maxlen = packed.peptide_maxlen
        self.pocket_maxlen = packed.pocket_maxlen
        self.nbytes = packed.nbytes
        self._packed = packed
        self._data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                      for k, v in packed._data.items()}

    def __len__(self) -> int:
        return len(self.entry_names)

    def __getitem__(self, index: int):
        out = {k: v[index] for k, v in self._data.items()}
        out["name"] = self.entry_names[index]
        return out

    def get_batch(self, indices: Sequence[int]):
        idx = torch.as_tensor(np.asarray(indices, np.int64))
        if self.device.type == "cuda":
            # from pinned memory the copy waits for none of the queued work
            idx = idx.pin_memory()
        idx = idx.to(self.device, non_blocking=True)
        out = {k: v.index_select(0, idx) for k, v in self._data.items()}
        out["name"] = [self.entry_names[i] for i in indices]
        return out

    def get_protein_positions(self, entry_names: List[str]):
        return self._packed.get_protein_positions(entry_names)


def open_dataset(path: str, pack: bool = False, num_workers: int = 4):
    """An entry point's dataset: a path ending in ``.npz`` is a packed file
    (``PackedDataset.load``); any other path is HDF5, read entry by entry
    (``PmhcDataset``) or decoded once (``pack``). HDF5 without h5py raises
    ``SystemExit`` naming the pack command."""
    if path.endswith(".npz"):
        return PackedDataset.load(path)
    try:
        import h5py  # noqa: F401
    except ImportError:
        raise SystemExit(
            f"{path}: reading HDF5 needs h5py, which this machine lacks. Pack the file "
            f"where h5py exists (`{PACK_COMMAND}`) and pass the .npz") from None
    return PackedDataset(path, num_workers=num_workers) if pack else PmhcDataset(path)


def main(argv=None) -> None:
    from argparse import ArgumentParser

    p = ArgumentParser(description="Pack a SwiftMHC HDF5 file into the port's .npz form.")
    p.add_argument("hdf5", help="input SwiftMHC HDF5 file")
    p.add_argument("npz", help="output packed file (.npz)")
    p.add_argument("--num-workers", "-w", type=int, default=8)
    args = p.parse_args(argv)
    ds = PackedDataset(args.hdf5, num_workers=args.num_workers)
    ds.save(args.npz)
    print(f"packed {len(ds)} entries of {args.hdf5} into {args.npz}", file=sys.stderr)


if __name__ == "__main__":
    main()
