"""The port's multi-GPU layer (``pmhc_tpu_torch/parallel``, ``Trainer(mesh=)``,
the CLIs' ``--mesh-*`` flags) on the CPU, against the JAX package.

The JAX side runs here on conftest's 8 virtual CPU devices; the port side
runs in gloo groups of spawned processes (``parallel.distributed.spawn``,
rank bodies in ``tests/_torch_mesh_ranks.py``), each with a deadline
after which its ranks are killed and the test fails. Inputs come from
seeds (numpy). Held: ``make_mesh``'s axis sizes against the JAX
``make_mesh`` for worlds 1/2/4/8; the 48 tensors' tensor-parallel layout
against ``tp_param_shardings`` (transposed) and the parts' gather; the
group, ``loader_shard_args`` and the mesh, trainer and sharded-sampler
errors (JAX's messages); DP(2),
CP(2), ring(2) and TP(2) ``Trainer`` steps against the single-process
``Trainer`` on the same global batches and seed (losses to rtol 1e-5, the
parameters' change over 3 Adam steps to 1e-2 over all tensors and 1e-4
for the median one: Adam's first steps turn the last bits of a gradient
near zero into lr-sized moves); a DP(2) step's loss sums against the JAX
package's ``make_train_step(mesh=make_mesh(n_data=2))`` with the same t
and noise (rtol 1e-5); the train CLI on DP, TP and CP meshes (ranks
it starts itself, and two ranks started by ``torchrun``) and the sample
CLI on a CP mesh end to end.
"""

import os
import signal
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from pmhc_tpu.diffusion.noise import gen_noise as j_gen_noise
from pmhc_tpu.diffusion.sampler import make_sample_sharded as j_make_sample_sharded
from pmhc_tpu.diffusion.schedule import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.parallel import make_mesh as j_make_mesh
from pmhc_tpu.parallel import tp_param_shardings as j_tp_param_shardings
from pmhc_tpu.train.trainer import Trainer as JTrainer
from pmhc_tpu.train.trainer import make_train_step as j_make_train_step
from pmhc_tpu.train.trainer import prepare_batch as j_prepare_batch
from pmhc_tpu_torch.cli import sample_cli, train_cli
from pmhc_tpu_torch.data.synthetic import synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig
from pmhc_tpu_torch.diffusion.sampler import make_sample_sharded
from pmhc_tpu_torch.models import ScoreNetwork, ScoreNetworkConfig
from pmhc_tpu_torch.parallel import tp_param_shardings
from pmhc_tpu_torch.parallel.distributed import free_port, spawn
from pmhc_tpu_torch.train import TrainConfig, Trainer
from tests import _torch_mesh_ranks as ranks
from tests.test_torch_egnn import params_pair

torch.set_num_threads(1)
DEADLINE_S = 180.0
# Trainer comparisons: losses, and the parameters' change from their start
LOSS_RTOL = 1e-5
CHANGE_TOL = {"rel": 1e-2, "median_rel": 1e-4}


def state_np(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def change_errors(got: dict, want: dict) -> dict:
    """``got``'s change against ``want``'s: over all tensors, and the
    median tensor's relative error."""
    diff = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    norm = sum(float(np.sum(want[k] ** 2)) for k in want)
    per = sorted(float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30))
                 for k in want)
    return {"rel": (diff / norm) ** 0.5, "median_rel": per[len(per) // 2]}


def test_parallel_exports_the_jax_names():
    import pmhc_tpu.parallel as j_parallel
    import pmhc_tpu_torch.parallel as t_parallel

    assert sorted(t_parallel.__all__) == sorted(j_parallel.__all__)
    assert all(callable(getattr(t_parallel, n)) for n in t_parallel.__all__)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_make_mesh_axis_sizes_match_jax(world):
    combos = [(m, c) for m, c in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4)) if m * c <= world]
    res = spawn(ranks.mesh_shapes, world, args=(combos,), device="cpu", timeout=DEADLINE_S)
    devices = jax.devices()[:world]
    for i, (m, c) in enumerate(combos):
        want = j_make_mesh(n_model=m, n_context=c, devices=devices).devices.shape
        assert all(r[i][0] == want for r in res), (m, c, want, res)
        # rank r sits where the JAX mesh puts device r
        coords = sorted((r[i][1], rank) for rank, r in enumerate(res))
        assert [rank for _, rank in coords] == list(range(world))


def test_tp_layout_matches_jax_partition_specs():
    """Every one of the 48 tensors: the port's placement on ``model`` is
    the JAX ``PartitionSpec`` transposed to torch's ``[out, in]``."""
    params, model = params_pair(seed=0)
    j_specs = j_tp_param_shardings(j_make_mesh(n_model=2), params)
    placements = tp_param_shardings(None, model)
    assert len(placements) == 48
    mlp = {"feature_mlp": "feature", "message_mlp": "message", "attention_mlp": "attention",
           "translation_mlp": "translation", "rotation_mlp": "rotation", "torsion_mlp": "torsion"}
    for name, place in placements.items():
        layer, m, seq, kind = name.split(".")
        spec = tuple(j_specs[layer][mlp[m]][{"0": "lin1", "2": "lin2"}[seq]]
                     [{"weight": "w", "bias": "b"}[kind]].spec)
        spec = spec + (None,) * (len(model.state_dict()[name].shape) - len(spec))
        torch_spec = spec[::-1]  # [in, out] -> [out, in]
        want = [d for d, axis in enumerate(torch_spec) if axis == "model"]
        got = [place.dim] if place.is_shard() else []
        assert got == want, (name, spec, place)


@pytest.fixture(scope="module")
def basics():
    _, model = params_pair(seed=1)
    return state_np(model), spawn(ranks.group_basics, 2, args=(state_np(model),), device="cpu",
                                  timeout=DEADLINE_S)


def test_initialize_multihost_and_loader_shard_args(basics):
    _, res = basics
    for rank, r in enumerate(res):
        assert (r["backend"], r["rank"], r["world"]) == ("gloo", rank, 2)
        assert r["loader"] == {"process_index": rank, "process_count": 2}
        assert r["order"] == list(range(rank, 10, 2))


def test_tp_parts_and_gather(basics):
    """Each rank keeps its chunk of every split tensor; the gather gives
    the whole tensor back exactly; replicated tensors stay whole."""
    state, res = basics
    for name, full in state.items():
        for rank, r in enumerate(res):
            place = tp_param_shardings(None, [name])[name]
            want = np.split(full, 2, axis=place.dim)[rank] if place.is_shard() else full
            np.testing.assert_array_equal(r["parts"][name], want, err_msg=name)
            np.testing.assert_array_equal(r["whole"][name], full, err_msg=name)


def test_mesh_errors_are_jax_messages(basics):
    _, res = basics
    errors = res[0]["errors"]
    assert "torchrun --nproc-per-node 3" in errors["too_big"]
    with pytest.raises(ValueError) as e:
        JTrainer(JConfig(backend="xla"), JDiffusionConfig(), mesh=j_make_mesh(n_context=2),
                 context_parallel=True)
    assert errors["cp_backend"] == str(e.value)
    with pytest.raises(ValueError) as e:
        JTrainer(JConfig(backend="cp"), JDiffusionConfig(), mesh=j_make_mesh(n_model=2),
                 tensor_parallel=True, context_parallel=True)
    assert errors["dp_tp_cp"] == str(e.value)
    with pytest.raises(ValueError) as e:
        j_make_sample_sharded(JDiffusionConfig(), JConfig(backend="xla"), j_make_mesh(n_context=2))
    with pytest.raises(ValueError) as mine:
        make_sample_sharded(DiffusionConfig(), ScoreNetworkConfig(backend="xla"), None)
    assert str(mine.value) == str(e.value)


TRAINER_CONFIGS = {
    # mesh shape, backend, tensor parallel, context parallel, clip, per-sample t
    "dp2": ((2, 1, 1), "auto", False, False, None, True),
    "cp2": ((1, 1, 2), "cp", False, True, None, False),
    "ring2": ((1, 1, 2), "ring", False, True, None, False),
    "tp2_clip": ((1, 2, 1), "dense", True, False, 0.5, False),
    "tp2_kernels": ((1, 2, 1), "auto", True, False, None, True),
}


def single_trainer(backend, clip, per_sample, batches):
    tr = Trainer(ScoreNetworkConfig(backend=backend), DiffusionConfig(t_per_batch=not per_sample),
                 TrainConfig(seed=3, grad_clip_norm=clip), device="cpu")
    start = state_np(tr.model)
    losses = [float(tr.train_batch(b)["total loss"]) for b in batches]
    return losses, {k: v - start[k] for k, v in state_np(tr.model).items()}


@pytest.fixture(scope="module")
def trainer_runs():
    batches = [synthetic_batch(batch_size=6, seed=40 + k) for k in range(3)]
    res = spawn(ranks.trainer_runs, 2, args=(list(TRAINER_CONFIGS.values()), batches),
                device="cpu", timeout=DEADLINE_S)
    return batches, res


@pytest.mark.parametrize("name", list(TRAINER_CONFIGS))
def test_mesh_trainer_matches_single_process(trainer_runs, name):
    batches, res = trainer_runs
    i = list(TRAINER_CONFIGS).index(name)
    _, backend, _, _, clip, per_sample = TRAINER_CONFIGS[name]
    want_l, want_c = single_trainer("dense" if backend in ("cp", "ring") else backend, clip,
                                    per_sample, batches)
    for rank in range(2):
        losses, change = res[rank][i]
        np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL, err_msg=f"{name} rank {rank}")
        err = change_errors(change, want_c)
        assert err["rel"] <= CHANGE_TOL["rel"] and err["median_rel"] <= CHANGE_TOL["median_rel"], \
            (name, rank, err)
    # every rank holds the same parameters
    for k in res[0][i][1]:
        np.testing.assert_array_equal(res[0][i][1][k], res[1][i][1][k], err_msg=k)


def test_dp_first_step_matches_jax_make_train_step():
    """DP(2) against the JAX package's GSPMD step on a data-2 mesh: the
    same weights, batch, t and noise (the JAX step's own draws, replayed)
    give the same global loss sums."""
    params, model = params_pair(seed=2)
    nb = synthetic_batch(batch_size=8, seed=7)
    cfg, dc = JConfig(), JDiffusionConfig()
    opt = optax.adam(1e-3)
    step = j_make_train_step(cfg, dc, opt, mesh=j_make_mesh(n_data=2))
    _, key_t, key_eps = jax.random.split(jax.random.key(5), 3)
    t = int(jax.random.randint(key_t, (), 0, dc.noise_step_count))
    eps = j_gen_noise(key_eps, nb["mask"].shape, dc)
    eps = tuple(np.asarray(x) for x in (eps["frames"].quats, eps["frames"].trans, eps["torsions"]))
    want = step(params, opt.init(params), j_prepare_batch(nb), jax.random.key(5))[3]  # donates
    res = spawn(ranks.dp_first_step, 2, args=(state_np(model), nb, t, eps), device="cpu",
                timeout=DEADLINE_S)
    for r in res:
        for name, v in want.items():
            np.testing.assert_allclose(r[name], float(v), rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    from pmhc_tpu.data import write_synthetic_hdf5
    from pmhc_tpu_torch.data import PackedDataset

    d = tmp_path_factory.mktemp("mesh_cli")
    write_synthetic_hdf5(str(d / "train.hdf5"), n_entries=8, peptide_lengths=(9, 10), seed=0)
    write_synthetic_hdf5(str(d / "test.hdf5"), n_entries=3, peptide_lengths=(9, 16), seed=1)
    for name in ("train", "test"):
        PackedDataset(str(d / f"{name}.hdf5")).save(str(d / f"{name}.npz"))
    return d


def _state(path):
    return {k: v.numpy() for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}


TRAIN_ARGS = ["1", "-T", "8", "-b", "4", "--ema-decay", "0.9", "--device", "cpu"]


def _torchrun(argv, world):
    """``train_cli`` on ``world`` ranks started by ``torchrun``; its
    output. Every process it starts is killed after ``DEADLINE_S``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
           "--master-addr", "localhost", "--master-port", str(free_port()),
           "-m", "pmhc_tpu_torch.cli.train_cli", *argv]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.dirname(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        out, _ = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out
    return out


def _train_run(d, label, extra, torchrun=False):
    """``train_cli`` one epoch from the same start weights (a ``.pth`` it
    resumes from) into ``<label>.pth``, in this process or under
    ``torchrun`` on two ranks: its state and CSV rows."""
    model = str(d / f"{label}.pth")
    torch.save(ScoreNetwork(generator=torch.Generator().manual_seed(0)).state_dict(), model)
    start = _state(model)
    argv = [str(d / "train.npz"), TRAIN_ARGS[0], model] + TRAIN_ARGS[1:] + extra
    if torchrun:
        _torchrun(argv, 2)
    else:
        out = train_cli.main(argv)
        assert out["epochs"][0]["examples"] == 8
    ScoreNetwork().load_state_dict(torch.load(model, weights_only=True), strict=True)
    ScoreNetwork().load_state_dict(torch.load(model.replace(".pth", ".ema.pth"), weights_only=True),
                                   strict=True)
    with open(model.replace(".pth", ".csv")) as f:
        rows = f.read().splitlines()
    return {k: v - start[k] for k, v in _state(model).items()}, rows


@pytest.fixture(scope="module")
def one_process_train(cli_data):
    return _train_run(cli_data, "one", [])


@pytest.mark.parametrize("flags", [["--mesh-data", "2"], ["--mesh-model", "2"],
                                   ["--mesh-context", "2"]], ids=["data", "model", "context"])
def test_train_cli_mesh_data_matches_one_process(cli_data, one_process_train, monkeypatch, flags):
    """``--mesh-data 2`` (DP), ``--mesh-model 2`` (TP: the loop kernels on
    gathered weights) and ``--mesh-context 2`` (the ``cp`` layer) with
    ``--device cpu`` start their two ranks; rank 0 writes the reference
    files (``.pth`` and ``.ema.pth`` load strict: TP parts gathered), and
    the weights and the CSV's losses move as a one-process run's do."""
    monkeypatch.setattr("pmhc_tpu_torch.cli.SPAWN_TIMEOUT_S", DEADLINE_S)
    change, rows = _train_run(cli_data, flags[0].strip("-"), flags)
    want_change, want_rows = one_process_train
    err = change_errors(change, want_change)
    assert err["rel"] <= CHANGE_TOL["rel"] and err["median_rel"] <= CHANGE_TOL["median_rel"], err
    assert rows[0] == want_rows[0] and len(rows) == len(want_rows) == 2
    np.testing.assert_allclose([float(x) for x in rows[1].split(",")],
                               [float(x) for x in want_rows[1].split(",")], rtol=0,
                               atol=1.5e-3)  # the CSV's last printed decimal


def test_train_cli_under_torchrun_leaves_and_matches_one_process(cli_data, one_process_train):
    """Two ranks started by ``torchrun`` join its group (gloo with
    ``--device cpu``), train one epoch of ``--mesh-data 2`` and end their
    processes with ``leave`` (a barrier, the group not torn down): exit
    code 0 within the deadline, rank 0's files as a one-process run's."""
    change, rows = _train_run(cli_data, "torchrun", ["--mesh-data", "2"], torchrun=True)
    want_change, want_rows = one_process_train
    err = change_errors(change, want_change)
    assert err["rel"] <= CHANGE_TOL["rel"] and err["median_rel"] <= CHANGE_TOL["median_rel"], err
    assert rows[0] == want_rows[0] and len(rows) == len(want_rows) == 2
    np.testing.assert_allclose([float(x) for x in rows[1].split(",")],
                               [float(x) for x in want_rows[1].split(",")], rtol=0,
                               atol=1.5e-3)  # the CSV's last printed decimal


def test_sample_cli_mesh_context_writes_every_pdb_once(cli_data, monkeypatch, tmp_path):
    """``--mesh-context 2 --device cpu``: two ranks split the neighbours,
    rank 0 writes one PDB per entry, whose atoms lie where the one-process
    dense sampler puts them."""
    monkeypatch.setattr("pmhc_tpu_torch.cli.SPAWN_TIMEOUT_S", DEADLINE_S)
    d = cli_data
    model = str(tmp_path / "m.pth")
    torch.save(ScoreNetwork(generator=torch.Generator().manual_seed(4)).state_dict(), model)
    base = [model, str(d / "test.npz"), "-T", "4", "-b", "4", "--device", "cpu"]
    mesh = sample_cli.main(base + ["--mesh-context", "2", "--output-dir", str(tmp_path / "mesh")])
    one = sample_cli.main(base + ["--backend", "xla", "--output-dir", str(tmp_path / "one")])
    assert mesh["pdbs"] == one["pdbs"] == 3
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "mesh")) == names
    for name in names:
        got, want = (np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                               for ln in open(tmp_path / run / name) if ln.startswith("ATOM")])
                     for run in ("mesh", "one"))
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=name)
