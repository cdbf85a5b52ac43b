"""The port's offline CLIs (``pmhc_tpu_torch.cli.train_cli`` and
``sample_cli``) end to end on the CPU (``--device cpu``, the kernels'
plain versions), mirroring ``tests/e2e/test_cli.py`` and
``tests/e2e/test_checkpoint_resume.py`` at T = 4-8, batch 2-3, 6-8
entries. Data: HDF5 files from ``pmhc_tpu.data.write_synthetic_hdf5``.
What is held against the JAX package: the CSV header (``pmhc_tpu``'s
``MetricsRecord.save``), the ``.pth`` keys (``export_torch_checkpoint``'s
48 names) and the sampled files' names (``pmhc_tpu``'s
``PmhcDataset.entry_names``). Runs that must agree (an ``.npz`` input and
its HDF5; ``--steps-per-dispatch``) agree exactly.
"""

import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from pmhc_tpu.data import PmhcDataset as JDataset
from pmhc_tpu.data import write_synthetic_hdf5
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models import init_score_network
from pmhc_tpu.models.import_torch import export_torch_checkpoint
from pmhc_tpu.train.metrics import MetricsRecord as JMetrics
from pmhc_tpu_torch.cli import sample_cli, train_cli
from pmhc_tpu_torch.data import PackedDataset
from pmhc_tpu_torch.train import CheckpointManager

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_synthetic_hdf5(str(d / "train.hdf5"), n_entries=6, peptide_lengths=(9, 10), seed=0)
    write_synthetic_hdf5(str(d / "test.hdf5"), n_entries=3, peptide_lengths=(9, 16), seed=1)
    for name in ("train", "test"):
        PackedDataset(str(d / f"{name}.hdf5")).save(str(d / f"{name}.npz"))
    return d


@pytest.fixture(scope="module")
def trained(data_dir):
    """A model trained 2 epochs, then resumed for a third."""
    model = str(data_dir / "model.pth")
    out = train_cli.main([str(data_dir / "train.hdf5"), "2", model, "-T", "8",
                          "--batch-size", "3", "--num-workers", "2"] + CPU)
    train_cli.main([str(data_dir / "train.hdf5"), "1", model, "-T", "8", "--batch-size", "3"]
                   + CPU)
    return model, out


def _rows(path):
    with open(path) as f:
        return f.read().strip().splitlines()


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _coords(path):
    lines = [ln for ln in _rows(path) if ln.startswith("ATOM")]
    return np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in lines])


def test_train_then_resume(trained, tmp_path):
    """CSV rows per epoch (3 after the resume), the JAX package's header,
    the JAX exporter's 48 names, and per-epoch timings from ``main``."""
    model, out = trained
    rows = _rows(model.replace(".pth", ".csv"))
    assert len(rows) == 4
    ref = JMetrics()
    ref.add_batch({k: np.float32(1.0) for k in
                   ("total loss", "positions loss", "rotations loss", "torsions loss", "rmsd")}, 1)
    ref.save(str(tmp_path / "ref.csv"), 0)
    assert rows[0] == _rows(str(tmp_path / "ref.csv"))[0]
    path = str(tmp_path / "export.pth")
    export_torch_checkpoint(init_score_network(jax.random.key(0), JConfig()), path)
    assert set(_load(model)) == set(_load(path)) and len(_load(model)) == 48
    assert [e["examples"] for e in out["epochs"]] == [6, 6]
    assert all(e["loader_wait_s"] >= 0 and e["seconds"] > 0 for e in out["epochs"])


def test_validation_csv_with_frozen_and_moving_weights(data_dir, tmp_path):
    """--val-hdf5: at lr 0 (with --grad-accum 2) every epoch's held-out
    row is identical (fixed draws per batch index); with a learning rate
    the rows move, and --ema-decay adds <model>.val.ema.csv."""
    frozen = str(tmp_path / "frozen.pth")
    train_cli.main([str(data_dir / "train.hdf5"), "2", frozen, "-T", "8", "-b", "3",
                    "--val-hdf5", str(data_dir / "test.hdf5"), "--grad-accum", "2", "--lr", "0.0"]
                   + CPU)
    rows = _rows(frozen.replace(".pth", ".val.csv"))
    assert len(rows) == 3 and rows[1].split(",")[1:] == rows[2].split(",")[1:]
    moving = str(tmp_path / "moving.pth")
    train_cli.main([str(data_dir / "train.npz"), "2", moving, "-T", "8", "-b", "3", "--lr", "0.05",
                    "--val-hdf5", str(data_dir / "test.npz"), "--ema-decay", "0.5"] + CPU)
    rows = _rows(moving.replace(".pth", ".val.csv"))
    assert len(rows) == 3 and rows[1].split(",")[1:] != rows[2].split(",")[1:]
    assert len(_rows(moving.replace(".pth", ".val.ema.csv"))) == 3


def test_restart_on_nan(data_dir, tmp_path, caplog):
    """An absurd lr drives the loss to NaN: the default aborts; with a
    recovery budget the run restores the .pth, reseeds and finishes."""
    model = str(tmp_path / "nan.pth")
    base = [str(data_dir / "train.hdf5"), "1", model, "-T", "8", "--batch-size", "3"] + CPU
    train_cli.main(base)
    with pytest.raises(RuntimeError, match="NaN loss"):
        train_cli.main(base + ["--lr", "1e18"])
    with caplog.at_level(logging.WARNING):
        train_cli.main([str(data_dir / "train.hdf5"), "2", model, "-T", "8", "--batch-size", "3",
                        "--lr", "1e18", "--restart-on-nan", "4"] + CPU)
    assert any("reseeded the generators" in r.message for r in caplog.records)
    assert os.path.isfile(model)


def test_ema_and_sampling_from_it(data_dir, tmp_path):
    model = str(tmp_path / "ema.pth")
    train_cli.main([str(data_dir / "train.hdf5"), "2", model, "-T", "8", "--batch-size", "3",
                    "--ema-decay", "0.9"] + CPU)
    ema_path = model.replace(".pth", ".ema.pth")
    raw, ema = _load(model), _load(ema_path)
    assert set(raw) == set(ema)
    assert max(float((raw[k] - ema[k]).abs().max()) for k in raw) > 1e-6
    out = str(tmp_path / "sampled")
    sample_cli.main([ema_path, str(data_dir / "test.hdf5"), "-T", "4", "-b", "2",
                     "--output-dir", out] + CPU)
    assert len(os.listdir(out)) == 3


def test_checkpoint_dir_resume_and_flag_mismatch(data_dir, tmp_path):
    """--orbax-dir holds the port's full-state checkpoints: a second run
    restores the latest step and goes on from it; a run whose optimizer
    flags differ stops with a message naming them; the sample CLI reads
    the directory's latest weights."""
    model, ckdir = str(tmp_path / "m.pth"), str(tmp_path / "ck")
    base = [str(data_dir / "train.hdf5"), "1", model, "-T", "6", "--batch-size", "2",
            "--orbax-dir", ckdir] + CPU
    train_cli.main(base)
    assert CheckpointManager(ckdir).latest_step() == 3
    train_cli.main(base)
    assert CheckpointManager(ckdir).latest_step() == 6
    with pytest.raises(SystemExit) as ei:
        train_cli.main(base + ["--grad-accum", "2"])
    assert "--grad-accum" in str(ei.value) and "--orbax-dir" in str(ei.value)
    out = str(tmp_path / "sampled")
    sample_cli.main([ckdir, str(data_dir / "test.hdf5"), "-T", "6", "-b", "4",
                     "--output-dir", out] + CPU)
    assert len(os.listdir(out)) == 3


@pytest.mark.parametrize("extra", [["-b", "2"], ["-b", "2", "--device-data"], ["-b", "4"],
                                   ["-b", "4", "--device-data"]],
                         ids=["loader", "device_data", "partial_batch", "device_data_partial"])
def test_steps_per_dispatch_equals_one_step_at_a_time(data_dir, tmp_path, extra):
    """K = 2 batches per call (with --device-data: ``train_indices`` on the
    index rows of full K-groups, then the leftover full batches and the
    partial one a batch at a time) give the same weights and CSV as one at
    a time; at batch 4 the full batch waiting for a second one trains
    before the partial final batch (6 entries)."""
    paths = {}
    for k in ("1", "2"):
        paths[k] = str(tmp_path / f"k{k}.pth")
        train_cli.main([str(data_dir / "train.hdf5"), "1", paths[k], "-T", "8",
                        "--steps-per-dispatch", k] + extra + CPU)
    a, b = _load(paths["1"]), _load(paths["2"])
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert _rows(paths["1"].replace(".pth", ".csv")) == _rows(paths["2"].replace(".pth", ".csv"))


def test_sample_cli_writes_each_batch_as_the_service_samples_it(trained, data_dir, tmp_path):
    """Batch i's PDBs are written while batch i+1 samples: every file holds
    the bytes ``SamplerService`` gives for its own batch sampled alone with
    that batch's generator (3 entries at batch 2, 2 samples: 4 batches)."""
    from pmhc_tpu_torch.models.import_params import load_params
    from pmhc_tpu_torch.serve import SamplerService

    model, _ = trained
    out = tmp_path / "o"
    sample_cli.main([model, str(data_dir / "test.npz"), "-T", "4", "-b", "2", "--num-samples",
                     "2", "--seed", "5", "--output-dir", str(out)] + CPU)
    ds = PackedDataset.load(str(data_dir / "test.npz"))
    svc = SamplerService(load_params(model), batch_size=2, noise_step_count=4, seed=5,
                         device="cpu")
    counter = 0
    for start in range(0, len(ds), 2):
        batch = ds.get_batch(list(range(start, min(start + 2, len(ds)))))
        names = batch.pop("name")
        protein = ds.get_protein_positions(names)
        entries = [{**{k: v[i] for k, v in batch.items()}, **{k: v[i] for k, v in protein.items()}}
                   for i in range(len(names))]
        for si in range(2):
            pdbs = svc.sample_entries(entries, svc.batch_generator(counter))
            counter += 1
            for name, pdb in zip(names, pdbs):
                assert (out / f"{name}.{si + 1}.pdb").read_bytes() == pdb, (name, si)
    assert len(os.listdir(out)) == 6


def test_packed_input_equals_hdf5_input(data_dir, tmp_path):
    """The same seed on the .npz and on its HDF5 (also with --pack): the
    same CSV and the same .pth."""
    runs = {}
    for label, path, extra in (("hdf5", "train.hdf5", []), ("pack", "train.hdf5", ["--pack"]),
                               ("npz", "train.npz", ["--pack"])):
        model = str(tmp_path / f"{label}.pth")
        train_cli.main([str(data_dir / path), "2", model, "-T", "8", "-b", "3", "--seed", "3"]
                       + extra + CPU)
        runs[label] = (_load(model), _rows(model.replace(".pth", ".csv")))
    for label in ("pack", "npz"):
        assert runs[label][1] == runs["hdf5"][1]
        assert all(torch.equal(runs[label][0][k], runs["hdf5"][0][k]) for k in runs["hdf5"][0])


def test_sample_cli_names_files_and_pads_a_short_batch(trained, data_dir, tmp_path):
    """3 entries at batch 2: a full batch and a short one (padded); one
    parsed PDB per entry, named as the JAX dataset names the entries; the
    16-mer keeps all 16 residues and its OXT. A --profile-dir trace."""
    model, _ = trained
    out, prof = str(tmp_path / "sampled"), str(tmp_path / "prof")
    stats = sample_cli.main([model, str(data_dir / "test.hdf5"), "-T", "4", "-b", "2",
                             "--output-dir", out, "--profile-dir", prof] + CPU)
    names = JDataset(str(data_dir / "test.hdf5")).entry_names
    assert sorted(os.listdir(out)) == sorted(f"{n}.pdb" for n in names)
    assert [b["entries"] for b in stats["batches"]] == [2, 1]
    for n in names:
        lines = [ln for ln in _rows(os.path.join(out, f"{n}.pdb")) if ln.startswith("ATOM")]
        assert {ln[21] for ln in lines} == {"P", "M"}
        assert np.isfinite(_coords(os.path.join(out, f"{n}.pdb"))).all()
    full = [ln for ln in _rows(os.path.join(out, f"{names[1]}.pdb"))
            if ln.startswith("ATOM") and ln[21] == "P"]
    assert max(int(ln[22:26]) for ln in full) == 16 and any(ln[12:16].strip() == "OXT" for ln in full)
    assert os.path.isfile(os.path.join(prof, "trace.json"))


def test_sample_cli_num_samples_and_strided_steps(trained, data_dir, tmp_path):
    model, _ = trained
    out = str(tmp_path / "multi")
    sample_cli.main([model, str(data_dir / "test.npz"), "-T", "16", "--sample-steps", "4",
                     "-b", "2", "--num-samples", "2", "--bf16", "--output-dir", out] + CPU)
    names = JDataset(str(data_dir / "test.hdf5")).entry_names
    assert sorted(os.listdir(out)) == sorted(f"{n}.{k}.pdb" for n in names for k in (1, 2))
    c1, c2 = (_coords(os.path.join(out, f"{names[0]}.{k}.pdb")) for k in (1, 2))
    assert np.isfinite(c1).all() and np.isfinite(c2).all() and not np.allclose(c1, c2)


def test_npz_runs_without_h5py(trained, data_dir, tmp_path, monkeypatch):
    """A machine without h5py: both CLIs run on .npz files, and an HDF5
    path stops with the pack command in the message."""
    model, _ = trained
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises ImportError
    train_cli.main([str(data_dir / "train.npz"), "1", str(tmp_path / "m.pth"), "-T", "4",
                    "-b", "3", "--val-hdf5", str(data_dir / "test.npz")] + CPU)
    out = str(tmp_path / "s")
    sample_cli.main([model, str(data_dir / "test.npz"), "-T", "4", "-b", "3",
                     "--output-dir", out] + CPU)
    assert len(os.listdir(out)) == 3
    for main, args in ((train_cli.main, [str(data_dir / "train.hdf5"), "1",
                                         str(tmp_path / "h.pth")]),
                       (sample_cli.main, [model, str(data_dir / "test.hdf5")])):
        with pytest.raises(SystemExit, match="python -m pmhc_tpu_torch.data.packed"):
            main(args + ["-T", "4"] + CPU)


def test_validate_data_and_unported_options(data_dir, tmp_path, monkeypatch):
    """--validate-data passes a clean HDF5, refuses a packed file (the
    schema check reads HDF5); a mesh larger than the torchrun group the
    process was started in raises, naming torchrun; the backends cp and
    ring run (on the CPU without a mesh flag: one process, a context
    group of one)."""
    model = str(tmp_path / "v.pth")
    train_cli.main([str(data_dir / "train.hdf5"), "1", model, "-T", "4", "-b", "6",
                    "--validate-data", "--debug"] + CPU)
    assert not torch.is_anomaly_enabled()
    for main, args in ((train_cli.main, [str(data_dir / "train.npz"), "1", model]),
                       (sample_cli.main, [model, str(data_dir / "test.npz")])):
        with pytest.raises(SystemExit, match="before packing"):
            main(args + ["--validate-data", "-T", "4"] + CPU)
    train = [str(data_dir / "train.hdf5"), "1", model, "-T", "4"] + CPU
    from pmhc_tpu_torch.parallel.distributed import free_port

    # a torchrun group of one process
    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(k, v)
    for flags in (["--mesh-data", "2"], ["--mesh-model", "2"], ["--mesh-context", "2"]):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            train_cli.main(train + flags)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        sample_cli.main([model, str(data_dir / "test.hdf5"), "--mesh-context", "2"] + CPU)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    for backend in ("cp", "ring"):
        out = train_cli.main(train + ["--backend", backend])
        assert out["epochs"][0]["examples"] == 6
        out = sample_cli.main([model, str(data_dir / "test.hdf5"), "--backend", backend, "-T", "4",
                               "--output-dir", str(tmp_path / backend)] + CPU)
        assert out["pdbs"] == 3
