"""The port's blockwise layer (``pmhc_tpu_torch/models/egnn_blockwise.py``,
backend ``"blockwise"``) against ``pmhc_tpu.models.egnn_blockwise`` and the
port's dense layer on the same numpy inputs and weights.

Tolerances: against JAX's blockwise layer those of the port's layer tests
(``tests/test_torch_egnn.py``: quats 5e-5, the rest 2e-4); against the
port's dense layer those of ``tests/unit/test_blockwise.py`` (quats 5e-5,
the rest 2e-4); gradients against dense autograd 1e-4 absolute plus 1e-4
relative (fp32 sums in another order); the 4-step sampler against JAX's
generic sampler at ``tests/test_torch_sampler.py``'s (quats 2e-4,
translations 1e-3, torsions 2e-4); a ``Trainer`` step against a dense one
at ``test_trainer_pallas_tracks_dense``'s (losses rtol 1e-5, weights 3e-3).
"""

import http.client
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion import sample as j_sample
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models import score_network_forward as j_score_forward
from pmhc_tpu.models.egnn_blockwise import egnn_forward_blockwise as j_blockwise
from pmhc_tpu_torch.data import PackedDataset, write_synthetic_hdf5
from pmhc_tpu_torch.data.synthetic import synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, sample
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.models import ScoreNetworkConfig, egnn_forward
from pmhc_tpu_torch.models import score_network_forward as t_score_forward
from pmhc_tpu_torch.models.egnn_blockwise import egnn_forward_blockwise
from pmhc_tpu_torch.train import TrainConfig, Trainer
from tests.test_torch_egnn import (
    assert_layer_close,
    assert_pred_close,
    jax_model_batch,
    layer_args,
    numpy_batch,
    params_pair,
    torch_model_batch,
)
from tests.test_torch_sampler import T_STEPS, _assert_traj_close, _inputs

torch.set_num_threads(1)
BLOCKS = [16, 32, 96]


@pytest.mark.parametrize("layer", ["gnn1", "gnn2"])
@pytest.mark.parametrize("neighbour_block", BLOCKS)
def test_blockwise_matches_jax_blockwise(neighbour_block, layer):
    params, model = params_pair(seed=2)
    nb = numpy_batch(batch_size=3, seed=17)
    j_args, t_args = layer_args(nb, params[layer], getattr(model, layer), inner=layer == "gnn2")
    j_out = jax.jit(lambda *a: j_blockwise(params[layer], *a, neighbour_block=neighbour_block))(
        *j_args)
    with torch.no_grad():
        t_out = egnn_forward_blockwise(getattr(model, layer), *t_args,
                                       neighbour_block=neighbour_block)
    assert_layer_close(t_out, j_out)


@pytest.mark.parametrize("neighbour_block", BLOCKS)
def test_blockwise_matches_the_ports_dense_layer(neighbour_block):
    params, model = params_pair(seed=2)
    nb = numpy_batch(batch_size=3, seed=17)
    _, t_args = layer_args(nb, params["gnn1"], model.gnn1)
    with torch.no_grad():
        dense = egnn_forward(model.gnn1, *t_args)
        blk = egnn_forward_blockwise(model.gnn1, *t_args, neighbour_block=neighbour_block)
    (df, dt, dh), (bf, bt, bh) = dense, blk
    np.testing.assert_allclose(bf.quats.numpy(), df.quats.numpy(), atol=5e-5)
    np.testing.assert_allclose(bf.trans.numpy(), df.trans.numpy(), atol=2e-4)
    np.testing.assert_allclose(bt.numpy(), dt.numpy(), atol=2e-4)
    np.testing.assert_allclose(bh.numpy(), dh.numpy(), atol=2e-4)


def _loss(out):
    f, t, h = out
    return (f.trans ** 2).sum() + (f.quats ** 2).sum() + (t ** 2).sum() + (h ** 2).sum()


def test_blockwise_gradients_match_dense_autograd():
    """Every weight's gradient and those of the frames, torsions and
    features, through autograd of the block loop and of the dense layer."""
    params, model = params_pair(seed=4)
    nb = numpy_batch(batch_size=2, seed=5)
    _, t_args = layer_args(nb, params["gnn1"], model.gnn1)
    grads = {}
    for name, fn in (("dense", egnn_forward),
                     ("blockwise", lambda *a: egnn_forward_blockwise(*a, neighbour_block=32))):
        frames, tors, feats = t_args[:3]
        q = frames.quats.clone().requires_grad_(True)
        tr = frames.trans.clone().requires_grad_(True)
        tors = tors.clone().requires_grad_(True)
        feats = feats.clone().requires_grad_(True)
        out = fn(model.gnn1, TRigid(q, tr), tors, feats, *t_args[3:])
        grads[name] = torch.autograd.grad(_loss(out), [q, tr, tors, feats]
                                          + list(model.gnn1.parameters()))
    names = ["quats", "trans", "torsions", "features"] + [n for n, _ in model.gnn1.named_parameters()]
    for name, g, want in zip(names, grads["blockwise"], grads["dense"]):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


def test_blockwise_ragged_neighbours_raise():
    params, model = params_pair(seed=2)
    nb = numpy_batch(batch_size=2, seed=3)
    _, t_args = layer_args(nb, params["gnn1"], model.gnn1)
    with pytest.raises(ValueError, match="not divisible"):
        egnn_forward_blockwise(model.gnn1, *t_args, neighbour_block=40)  # NP = 96


@pytest.mark.parametrize("t", [1, 1000])
def test_score_network_blockwise_matches_jax(t):
    params, model = params_pair()
    nb = numpy_batch(seed=3)
    j_pred = j_score_forward(params, jax_model_batch(nb), jnp.asarray(t, jnp.int32),
                             JConfig(backend="blockwise"))
    with torch.no_grad():
        t_pred = t_score_forward(model, torch_model_batch(nb), t,
                                 ScoreNetworkConfig(backend="blockwise"))
    assert_pred_close(t_pred, j_pred)


def test_blockwise_sampler_matches_jax():
    params, model = params_pair(seed=2)
    nb, j_inj, t_inj = _inputs(T_STEPS)
    j_out = j_sample(params, jax_model_batch(nb), jax.random.key(0),
                     JDiffusionConfig(noise_step_count=T_STEPS),
                     JConfig(noise_step_count=T_STEPS, backend="blockwise"), injected_noise=j_inj)
    t_out = sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
                   ScoreNetworkConfig(noise_step_count=T_STEPS, backend="blockwise"),
                   injected_noise=t_inj)
    _assert_traj_close(t_out, j_out)


def test_trainer_blockwise_tracks_dense():
    """2 ``Trainer`` steps, same seed (weights, timesteps and noise),
    ``blockwise`` against ``dense``."""
    trainers = {bk: Trainer(ScoreNetworkConfig(backend=bk), train_config=TrainConfig(seed=3),
                            device="cpu") for bk in ("blockwise", "dense")}
    assert trainers["blockwise"].precision == "f32"
    for k in range(2):
        batch = synthetic_batch(batch_size=4, peptide_len=7 + k, seed=50 + k)
        sums = {bk: tr.train_batch(batch) for bk, tr in trainers.items()}
        for name, v in sums["dense"].items():
            np.testing.assert_allclose(float(sums["blockwise"][name]), float(v), rtol=1e-5,
                                       err_msg=f"step {k} {name}")
    for (name, p), q in zip(trainers["blockwise"].model.named_parameters(),
                            trainers["dense"].model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=3e-3, err_msg=name)


def test_blockwise_runs_in_the_three_clis(tmp_path):
    """``--backend blockwise`` through the train and sample CLIs and the HTTP
    server on the CPU; ``--bf16`` runs and reports fp32."""
    from pmhc_tpu_torch.cli import sample_cli, train_cli
    from pmhc_tpu_torch.cli.serve_cli import build_parser
    from tests.test_torch_serve_cli import _npz, _serve, _stop

    write_synthetic_hdf5(str(tmp_path / "d.hdf5"), n_entries=3, peptide_lengths=(9,), seed=0)
    data = str(tmp_path / "d.npz")
    PackedDataset(str(tmp_path / "d.hdf5")).save(data)
    model = str(tmp_path / "m.pth")
    flags = ["-T", "3", "-b", "2", "--backend", "blockwise", "--bf16", "--device", "cpu"]
    train_cli.main([data, "1", model] + flags)
    assert os.path.isfile(model)
    out = tmp_path / "sampled"
    sample_cli.main([model, data, "--output-dir", str(out)] + flags)
    assert len(os.listdir(out)) == 3
    args = build_parser().parse_args([model, "--port", "0", "--max-wait-ms", "5"] + flags)
    server, thread = _serve(args)
    try:
        conn = http.client.HTTPConnection(*server.server_address, timeout=300)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["backend"] == "blockwise" and health["precision"] == "f32"
        from pmhc_tpu_torch.serve import dummy_entry

        conn.request("POST", "/sample", _npz(dummy_entry()))
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read().endswith(b"END\n")
    finally:
        _stop(server, thread)
