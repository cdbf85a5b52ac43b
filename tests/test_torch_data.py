"""The port's data pipeline (``pmhc_tpu_torch.data``, ``io.pdb.save_pdb``)
against ``pmhc_tpu.data`` and ``pmhc_tpu.io.pdb`` on the same files.

Files are written by the JAX package's writers (``write_synthetic_hdf5``,
``write_realistic_hdf5``: ragged pockets, proteins of 150-180 residues,
8-11-mer peptides, and 16-mers for the last-residue psi rule). Every
comparison is exact: entries, protein arrays, writers' datasets, packed
files, the loader's index order and batch arrays, the validator's
``(checked, problems)`` and the PDB bytes.
"""

import os
import sys

import h5py
import jax  # noqa: F401  (the tier's convention: both frameworks importable)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.data import PackedDataset as JPacked
from pmhc_tpu.data import PmhcDataset as JDataset
from pmhc_tpu.data import PrefetchLoader as JLoader
from pmhc_tpu.data.realistic import write_realistic_hdf5 as j_write_realistic
from pmhc_tpu.data.synthetic import write_synthetic_hdf5 as j_write_synthetic
from pmhc_tpu.data.validate import validate_hdf5 as j_validate
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.io.pdb import save_pdb as j_save_pdb
from pmhc_tpu_torch.data import (
    DeviceDataset,
    PackedDataset,
    PmhcDataset,
    PrefetchLoader,
    synthetic_batch,
    write_realistic_hdf5,
    write_synthetic_hdf5,
)
from pmhc_tpu_torch.data import packed as packed_mod
from pmhc_tpu_torch.data.realistic import realistic_packed
from pmhc_tpu_torch.data.synthetic import prepare_batch
from pmhc_tpu_torch.data.validate import validate_hdf5
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.io.pdb import precompute_pdb_arrays, save_pdb
from tests.unit.test_validate_hdf5 import (
    _bad_aatype,
    _copy_with,
    _drop_peptide,
    _drop_torsion_mask,
    _empty_pocket,
    _narrow_onehot,
)

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "fixtures")
REALISTIC = dict(n_entries=7, seed=3)
SYNTHETIC = dict(n_entries=5, peptide_lengths=(9, 16, 10), seed=4)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    paths = {"realistic": str(d / "real.hdf5"), "synthetic": str(d / "syn.hdf5")}
    j_write_realistic(paths["realistic"], **REALISTIC)
    j_write_synthetic(paths["synthetic"], **SYNTHETIC)
    return paths


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset) else None)
    return out


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "name":
            assert list(a[k]) == list(b[k])
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", ["realistic", "synthetic"])
def test_get_entry_matches_jax(files, kind):
    ours, theirs = PmhcDataset(files[kind]), JDataset(files[kind])
    assert ours.entry_names == theirs.entry_names
    for i, name in enumerate(theirs.entry_names):
        _assert_same_arrays(ours.get_entry(name), theirs.get_entry(name))
        _assert_same_arrays(ours[i], theirs[i])


def test_get_protein_positions_matches_jax(files):
    ours, theirs = PmhcDataset(files["realistic"]), JDataset(files["realistic"])
    names = [theirs.entry_names[i] for i in (5, 0, 3)]
    lengths = {len(theirs.get_protein_positions([n])["protein_aatype"][0]) for n in names}
    assert len(lengths) > 1  # the case needs proteins of different lengths
    _assert_same_arrays(ours.get_protein_positions(names), theirs.get_protein_positions(names))


@pytest.mark.parametrize("kind", ["realistic", "synthetic"])
def test_writers_match_jax(files, tmp_path, kind):
    path = str(tmp_path / "ours.hdf5")
    if kind == "realistic":
        write_realistic_hdf5(path, **REALISTIC)
    else:
        write_synthetic_hdf5(path, **SYNTHETIC)
    _assert_same_arrays(_datasets(path), _datasets(files[kind]))


def test_packed_file_from_entries_equals_packed_hdf5(files, tmp_path):
    """Built from the realistic generator without HDF5, it equals the pack
    of the file written with that seed; saved and loaded, it gives the same
    batches and protein arrays as the JAX package's PackedDataset."""
    built = realistic_packed(**REALISTIC)
    a, b = str(tmp_path / "built.npz"), str(tmp_path / "packed.npz")
    built.save(a)
    packed_mod.main([files["realistic"], b])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    loaded, theirs = PackedDataset.load(a), JPacked(files["realistic"], num_workers=1)
    assert loaded.entry_names == theirs.entry_names
    for idx in ([0, 1, 2], [6, 3], [5]):
        _assert_same_arrays(loaded.get_batch(idx), theirs.get_batch(idx))
        names = [theirs.entry_names[i] for i in idx]
        _assert_same_arrays(loaded.get_protein_positions(names),
                            theirs.get_protein_positions(names))
    _assert_same_arrays(loaded[4], theirs[4])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("drop_last,process_index,process_count",
                         [(False, 0, 1), (True, 0, 1), (False, 1, 2)])
def test_loader_matches_jax(files, packed, drop_last, process_index, process_count):
    """Two shuffled epochs: the same entries in the same order, the same
    batch arrays (the thread-pool path and the packed fast path)."""
    path = files["realistic"]
    ours = PackedDataset(path, num_workers=1) if packed else PmhcDataset(path)
    theirs = JPacked(path, num_workers=1) if packed else JDataset(path)
    kw = dict(batch_size=2, shuffle=True, seed=11, num_workers=2, drop_last=drop_last,
              process_index=process_index, process_count=process_count)
    t_loader, j_loader = PrefetchLoader(ours, **kw), JLoader(theirs, device_put=False, **kw)
    assert len(t_loader) == len(j_loader)
    for _ in range(2):
        t_batches, j_batches = list(t_loader), list(j_loader)
        assert len(t_batches) == len(j_batches) == len(j_loader)
        for t, j in zip(t_batches, j_batches):
            _assert_same_arrays(t, j)


class _FlakyDataset:
    """Entry 5 raises, like a corrupt record mid-epoch."""

    def __init__(self, n=8):
        self.n = n
        self.entry = {k: v[0] for k, v in synthetic_batch(batch_size=1, seed=0).items()}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 5:
            raise OSError("corrupt entry")
        return dict(self.entry)


def test_loader_error_surfaces_and_loader_is_reusable():
    loader = PrefetchLoader(_FlakyDataset(), batch_size=2, num_workers=2)
    with pytest.raises(OSError, match="corrupt entry"):
        list(loader)
    with pytest.raises(OSError, match="corrupt entry"):  # a second epoch: the same
        list(loader)
    assert len(list(PrefetchLoader(_FlakyDataset(n=4), batch_size=2, num_workers=2))) == 2


def test_loader_to_device_and_device_dataset(files):
    """With a device, arrays become tensors there (names stay a list); a
    DeviceDataset batch is gathered there and passed on uncopied."""
    packed = PackedDataset(files["realistic"], num_workers=1)
    cpu = torch.device("cpu")
    want = list(PrefetchLoader(packed, batch_size=3, shuffle=True, seed=2))
    got = list(PrefetchLoader(packed, batch_size=3, shuffle=True, seed=2, device=cpu))
    on_device = DeviceDataset(packed, cpu)
    gathered = list(PrefetchLoader(on_device, batch_size=3, shuffle=True, seed=2, device=cpu))
    for w, g, d in zip(want, got, gathered):
        assert g["name"] == w["name"] == d["name"]
        for k in w:
            if k != "name":
                assert isinstance(g[k], torch.Tensor) and g[k].device == cpu
                np.testing.assert_array_equal(g[k].numpy(), w[k])
                np.testing.assert_array_equal(d[k].numpy(), w[k])
    batch = on_device.get_batch([1, 0])
    prepared = prepare_batch(batch, cpu)
    assert prepared["mask"] is batch["mask"]  # a tensor on the device passes untouched
    assert set(batch) == set(packed.get_batch([0]))


def test_device_dataset_loader_gathers_in_the_callers_thread():
    """A DeviceDataset's batches are gathered by the consumer: no producer
    thread runs while the loader is iterated, and the order is the one the
    packed dataset's loader gives."""
    import threading

    packed = realistic_packed(7, seed=4)
    before = threading.active_count()
    kw = dict(batch_size=3, shuffle=True, seed=5, device=torch.device("cpu"))
    names = []
    for batch in PrefetchLoader(DeviceDataset(packed, "cpu"), **kw):
        assert threading.active_count() == before
        names.append(batch["name"])
    assert names == [b["name"] for b in PrefetchLoader(packed, **kw)]


def test_prepare_batch_keeps_numpy_behaviour_and_passes_device_tensors():
    nb = synthetic_batch(batch_size=3, seed=5)
    from_numpy = prepare_batch(nb, "cpu")
    tensors = {k: torch.from_numpy(v) for k, v in nb.items()}
    from_tensors = prepare_batch(tensors, torch.device("cpu"))
    for k in ("mask", "features", "torsions", "pocket_mask"):
        assert from_tensors[k] is tensors[k]
        assert torch.equal(from_numpy[k], tensors[k])
    assert from_tensors["frames"].quats.data_ptr() == tensors["frames"].data_ptr()
    assert torch.equal(from_numpy["frames"].trans, from_tensors["frames"].trans)
    # float64 frames are cast to float32 either way
    f64 = prepare_batch({**nb, "frames": nb["frames"].astype(np.float64)}, "cpu")
    assert f64["frames"].quats.dtype == torch.float32


@pytest.mark.parametrize("mutate", [None, _drop_peptide, _drop_torsion_mask, _narrow_onehot,
                                    _bad_aatype, _empty_pocket, "transposed", "nan"])
def test_validate_matches_jax(files, tmp_path, mutate):
    src = files["synthetic"]
    if mutate is None:
        path = src
    else:
        path = str(tmp_path / "bad.hdf5")

        def transposed(e):
            fr = np.asarray(e["peptide/backbone_rigid_tensor"][:])
            e["peptide/backbone_rigid_tensor"].write_direct(np.transpose(fr, (0, 2, 1)).copy())

        def nan(e):
            pos = np.asarray(e["protein/atom14_gt_positions"][:])
            pos[0, 0, 0] = np.nan
            e["protein/atom14_gt_positions"].write_direct(pos)

        _copy_with(src, path, {"transposed": transposed, "nan": nan}.get(mutate, mutate))
    for strict in (True, False):
        ours = validate_hdf5(path, strict=strict)
        assert ours == j_validate(path, strict=strict)
    assert (ours[1] == []) == (mutate is None)  # not strict
    assert validate_hdf5(files["realistic"], max_entries=2) == j_validate(files["realistic"],
                                                                         max_entries=2)


@pytest.mark.parametrize("index", [0, 1])
def test_save_pdb_bytes_match_jax(tmp_path, index):
    data = dict(np.load(os.path.join(FIXTURES, "pdb_input.npz")))
    j_batch = {k: jnp.asarray(v) for k, v in data.items() if k != "frames"}
    j_batch["frames"] = JRigid.from_tensor_7(jnp.asarray(data["frames"]))
    t_batch = {k: torch.from_numpy(v) for k, v in data.items() if k != "frames"}
    t_batch["frames"] = TRigid.from_tensor_7(torch.from_numpy(data["frames"]))
    ours, theirs, pre = (str(tmp_path / f"{n}.pdb") for n in ("ours", "theirs", "pre"))
    save_pdb(t_batch, index, ours)
    j_save_pdb(j_batch, index, theirs)
    save_pdb(None, index, pre, precomputed=precompute_pdb_arrays(t_batch))
    with open(ours, "rb") as a, open(theirs, "rb") as b, open(pre, "rb") as c:
        mine = a.read()
        assert mine == b.read() == c.read()
    assert mine.endswith(b"END\n")


def test_open_dataset_without_h5py_reads_npz_and_names_the_pack_command(files, tmp_path,
                                                                         monkeypatch):
    path = str(tmp_path / "p.npz")
    PackedDataset(files["synthetic"], num_workers=1).save(path)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises ImportError
    ds = packed_mod.open_dataset(path)
    assert len(ds) == SYNTHETIC["n_entries"]
    with pytest.raises(SystemExit, match="python -m pmhc_tpu_torch.data.packed"):
        packed_mod.open_dataset(files["synthetic"])
    with pytest.raises(ValueError, match="ends in .npz"):
        ds.save(str(tmp_path / "p.bin"))
