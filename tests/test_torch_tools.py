"""The port's tool twins (``pmhc_tpu_torch/tools/``) and
``serve.entry_from_dataset`` against the JAX package's on the CPU.

- ``entry_from_dataset``: array by array equal to
  ``pmhc_tpu.serve.entry_from_dataset`` on an HDF5 file the JAX package's
  writer wrote, through the port's ``PmhcDataset`` and its ``PackedDataset``.
- ``flops``: ``layer_flops`` / ``forward_flops`` equal ``tools/flops.py``'s
  counts exactly, at the published width and at a scaled one.
- ``eval_rmsd``: with the same weights (``export_torch_checkpoint`` ->
  ``load_params``), the same start noise and the same injected per-step
  noise, its per-entry RMSD and pure-noise RMSD equal the JAX tool's masked
  formula over ``pmhc_tpu.diffusion.sample`` (xla, fp32) within 1e-5 A
  (measured <= 4.0e-7 A; T = 6, batch 4 with a short last batch; the dense
  backend against xla, and the fused backend, whose plain version sums in
  another order).
- Each tool runs once through ``main`` with ``--device cpu`` at T <= 8 and
  batch <= 4; its JSON keys are checked, and a bad config exits non-zero.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.data import PmhcDataset as JDataset
from pmhc_tpu.data import write_realistic_hdf5
from pmhc_tpu.data.loader import collate as j_collate
from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion import ScheduleTables as JTables
from pmhc_tpu.diffusion import sample as j_sample
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models import init_score_network
from pmhc_tpu.models.import_torch import export_torch_checkpoint
from pmhc_tpu.models.nn import DEFAULT_PRECISION
from pmhc_tpu.serve import entry_from_dataset as j_entry_from_dataset
from pmhc_tpu.train.trainer import prepare_batch as j_prepare_batch
from pmhc_tpu_torch.data import PackedDataset, PmhcDataset
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models.import_params import load_params
from pmhc_tpu_torch.serve import SamplerService, entry_from_dataset
from pmhc_tpu_torch.tools import bench_sampler, bench_serve, bench_train, eval_rmsd, flops
from pmhc_tpu_torch.tools import rmsd_backends
from tests.test_torch_sampler import _noise_np
from tools import flops as j_flops

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_STEPS = 6
RMSD_TOL = 1e-5  # A; measured <= 4.0e-7 (dense and fused)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 6-entry realistic HDF5 file (the JAX package's writer), its packed
    form, and random weights as a reference-format .pth (the JAX params)."""
    d = tmp_path_factory.mktemp("tools")
    h5, npz, pth = str(d / "test.hdf5"), str(d / "test.npz"), str(d / "model.pth")
    write_realistic_hdf5(h5, n_entries=6, seed=4)
    PackedDataset(h5).save(npz)
    params = init_score_network(jax.random.key(3), JConfig(noise_step_count=T_STEPS))
    export_torch_checkpoint(params, pth)
    return {"h5": h5, "npz": npz, "pth": pth, "params": params, "dir": str(d)}


def test_entry_from_dataset_matches_jax(files):
    jds = JDataset(files["h5"])
    for ds in (PmhcDataset(files["h5"]), PackedDataset.load(files["npz"])):
        for name in jds.entry_names:
            want = j_entry_from_dataset(jds, name)
            got = entry_from_dataset(ds, name)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("batch,inner,message", [(64, 64, 64), (7, 128, 96)])
def test_flops_counts_equal_the_jax_tool(batch, inner, message):
    assert flops.forward_flops(batch, inner, message) == j_flops.forward_flops(batch, inner, message)
    assert flops.layer_flops(batch, H=inner, M=message, O=1) == \
        j_flops.layer_flops(batch, H=inner, M=message, O=1)
    rows = flops.main(["--batch", str(batch), "--inner-size", str(inner),
                       "--message-size", str(message), "--sample-per-sec", "100",
                       "--train-steps-per-sec", "300", "--precision", "bf16"])
    assert rows[0]["forward_gflops"] == j_flops.forward_flops(batch, inner, message) / 1e9
    fwd = j_flops.forward_flops(batch, inner, message)
    assert rows[1]["achieved_tflops"] == pytest.approx(fwd * 100 * 1000 / batch / 1e12)
    assert rows[2]["achieved_tflops"] == pytest.approx(3 * fwd * 300 / 1e12)
    assert rows[2]["peak_tflops"] == 989.0


def test_flops_reads_bench_lines(tmp_path):
    path = tmp_path / "bench.jsonl"
    path.write_text("text line\n" + json.dumps(
        {"backend": "fused", "precision": "fast-f32", "batch_size": 64, "sample_steps": 1000,
         "samples_per_sec": 128.0, "card": "c"}) + "\n" + json.dumps(
        {"backend": "fused", "precision": "f32", "batch_size": 64, "steps_per_sec": 300.0,
         "card": "c"}) + "\n")
    rows = flops.main(["--from-json", str(path)])
    assert [r["kind"] for r in rows[1:]] == ["sample", "train"]
    fwd = j_flops.forward_flops(64)
    assert rows[1]["achieved_tflops"] == pytest.approx(fwd * 2000 / 1e12)
    assert rows[1]["peak_tflops"] == pytest.approx(989 / 3)
    assert rows[2]["peak_share_pct"] == pytest.approx(100 * 3 * fwd * 300 / 67e12)


def _jax_masked_rmsd(pred_trans, true_trans, mask):
    """``tools/eval_rmsd.py``'s formula."""
    sq = np.sum((pred_trans - true_trans) ** 2, axis=-1) * mask
    return np.sqrt(sq.sum(axis=-1) / mask.sum(axis=-1))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_eval_rmsd_matches_the_jax_tool_on_injected_noise(files, backend):
    B = 4
    jds = JDataset(files["h5"])
    service = SamplerService(load_params(files["pth"]), batch_size=B,
                             noise_step_count=T_STEPS, backend=backend, device="cpu")
    dataset = PmhcDataset(files["h5"])
    dc = JDiffusionConfig(noise_step_count=T_STEPS)
    mc = JConfig(noise_step_count=T_STEPS, backend="xla")
    rng = np.random.default_rng(17)
    for start_row in range(0, len(jds), B):
        names = jds.entry_names[start_row:start_row + B]
        n = len(names)
        q0, t0, tor0 = (x[0] for x in _noise_np(rng, 1, B))
        q, t, tor = _noise_np(rng, T_STEPS, B)
        # the JAX tool's loop body, with the noise injected
        jb = j_collate([jds.get_entry(x) for x in names])
        jb.pop("name")
        mb = j_prepare_batch(jb)
        true = np.asarray(mb["frames"].trans)
        mask = np.asarray(mb["mask"], dtype=np.float64)
        mb["frames"] = JRigid(jnp.asarray(q0[:n]), jnp.asarray(t0[:n]))
        mb["torsions"] = jnp.asarray(tor0[:n])
        inj = {"frames": JRigid(jnp.asarray(q[:, :n]), jnp.asarray(t[:, :n])),
               "torsions": jnp.asarray(tor[:, :n])}
        out = j_sample(files["params"], mb, jax.random.key(0), dc, mc, JTables(dc),
                       precision=DEFAULT_PRECISION, injected_noise=inj)
        want = _jax_masked_rmsd(np.asarray(out["frames"].trans), true, mask)
        want_noise = _jax_masked_rmsd(t0[:n], true, mask)
        # the port's tool, the same noise (the service's batch shape: padded to B)
        entries = [entry_from_dataset(dataset, x) for x in names]
        start = {"frames": RigidArray(torch.from_numpy(q0), torch.from_numpy(t0)),
                 "torsions": torch.from_numpy(tor0)}
        inj_t = {"frames": RigidArray(torch.from_numpy(q), torch.from_numpy(t)),
                 "torsions": torch.from_numpy(tor)}
        pred, noise = eval_rmsd.sample_rows(service, entries, torch.Generator(), start, inj_t)
        t_true = np.stack([e["frames"][..., 4:] for e in entries])
        t_mask = np.stack([e["mask"] for e in entries])
        np.testing.assert_allclose(eval_rmsd.masked_rmsd(pred, t_true, t_mask), want, atol=RMSD_TOL)
        np.testing.assert_allclose(eval_rmsd.masked_rmsd(noise, t_true, t_mask), want_noise,
                                   atol=1e-5)


def test_eval_rmsd_cli_reports_every_entry(files):
    report = eval_rmsd.main([files["pth"], files["npz"], "-T", str(T_STEPS), "-b", "4",
                             "--device", "cpu"])
    keys = {"entries", "T", "sample_steps", "backend", "mean_backbone_rmsd",
            "mean_pure_noise_rmsd", "per_entry", "precision", "device", "card", "seconds"}
    assert keys <= set(report)
    assert report["entries"] == 6 and len(report["per_entry"]) == 6
    assert report["precision"] == "f32" and report["card"] == "cpu"
    assert all(np.isfinite(v) for v in report["per_entry"].values())
    # a pure-noise start scores ~12 A on these entries
    assert 5.0 < report["mean_pure_noise_rmsd"] < 30.0
    bf16 = eval_rmsd.main([files["pth"], files["h5"], "-T", "4", "-b", "4", "--bf16",
                           "--sample-steps", "2", "--device", "cpu"])
    assert bf16["precision"] == "bf16" and bf16["sample_steps"] == 2
    # the same seed and batches: the same start noise
    assert bf16["mean_pure_noise_rmsd"] == pytest.approx(report["mean_pure_noise_rmsd"])


def test_rmsd_backends_runs_every_config(files):
    out = rmsd_backends.main([files["pth"], "-T", "4", "--entries", "3", "--data", "realistic",
                              "--device", "cpu"])
    rows = out["rows"]
    assert [(r["backend"], r["precision"]) for r in rows] == [
        ("dense", "fp32"), ("fused", "fp32"), ("fused", "bf16"), ("fused", "fast-f32"),
        ("pallas", "fp32")]
    assert [r["runs"] for r in rows] == ["f32", "f32", "bf16", "fast-f32", "f32"]
    assert rows[0]["role"] == "baseline"
    for r in rows[1:]:
        assert {"rmsd_mean", "rmsd_std", "rel_gap_vs_baseline", "ok", "card"} <= set(r)
    # fp32 backends from the same noise sample the same chain up to summation order
    assert rows[1]["rel_gap_vs_baseline"] < 1e-5 and rows[4]["rel_gap_vs_baseline"] < 1e-5
    assert out["verdict"] == "MATCH"
    with pytest.raises(ValueError, match="precision"):
        rmsd_backends.main([files["pth"], "--configs", "fused:fp16", "--device", "cpu"])


def test_rmsd_backends_exits_1_on_a_mismatch(files):
    # an rtol of -1 cannot hold: the verdict is MISMATCH and the module exits 1
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "pmhc_tpu_torch.tools.rmsd_backends", files["pth"],
                           "-T", "2", "--entries", "2", "--configs", "dense:fp32,fused:fp32",
                           "--rtol", "-1", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["verdict"] == "MISMATCH"


def test_bench_sampler_rows():
    rows = bench_sampler.main(["-T", "4", "-b", "2", "--iters", "2", "--backends", "fused,pallas",
                               "--fast-f32", "--device", "cpu"])
    assert [r["backend"] for r in rows] == ["fused", "pallas"]
    assert [r["precision"] for r in rows] == ["fast-f32", "f32"]
    for r in rows:
        assert {"samples_per_sec", "seconds_per_batch", "first_call_seconds", "card",
                "sample_steps", "batch_size"} <= set(r)
        assert len(r["seconds"]) == 2 and r["samples_per_sec"] > 0
    with pytest.raises(ValueError, match="unknown backend"):
        bench_sampler.main(["--backends", "fused,nope", "--device", "cpu"])


def test_bench_train_rows_and_failure():
    args = ["-T", "8", "--batches", "2", "--steps-per-dispatch", "2", "--iters", "1",
            "--repeats", "2", "--device", "cpu"]
    rows = bench_train.main(args + ["--bf16"])
    assert [(r["backend"], r["precision"]) for r in rows] == [("fused", "bf16"), ("pallas", "f32")]
    for r in rows:
        assert {"steps_per_sec", "examples_per_sec", "windows_steps_per_sec", "card"} <= set(r)
        assert len(r["windows_steps_per_sec"]) == 2 and np.isfinite(r["last_loss"])
    # a config that fails is reported and the run exits non-zero
    with pytest.raises(SystemExit) as exc:
        bench_train.main(args + ["--backends", "fused,cp"])
    assert exc.value.code != 0


def test_bench_serve_rows():
    rows = bench_serve.main(["-T", "4", "-b", "4", "--requests", "6", "--concurrency", "3",
                             "--warmup-requests", "2", "--max-wait-ms", "5", "--device", "cpu"])
    assert [r["warmup"] for r in rows] == [True, False]
    level = rows[1]
    assert level["ok"] == 6 and not level["errors"] and level["batches"] >= 2
    for key in ("requests_per_sec", "p50_s", "p90_s", "p99_s", "max_s", "precision", "card"):
        assert level[key] is not None
    with pytest.raises(SystemExit) as exc:
        bench_serve.main(["--backend", "blockwise", "--device", "cpu"])
    assert exc.value.code != 0
