"""The trainer's evaluation and multi-batch entry points
(``pmhc_tpu_torch.train.trainer``: ``eval_step``, ``Trainer.eval_batch``,
``train_batches``) against the JAX package's and against ``train_batch``.

Tolerances: ``eval_step`` against ``add_noise`` -> ``score_network_forward``
-> ``diffusion_loss`` of ``pmhc_tpu`` (the body of ``make_eval_step``), with
per-sample timesteps and injected noise, weights carried across by
``export_torch_checkpoint`` -> ``load_checkpoint``: the dense layer 1e-5
relative (fp32), the loop layer's plain version 5e-4 relative (the loop
layer's tolerance of ``test_torch_train.py``). ``train_batches``, also on
batches a ``DeviceDataset`` gathers, against ``train_batch``: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.diffusion.loss import diffusion_loss as j_loss
from pmhc_tpu.diffusion.noise import add_noise as j_add_noise
from pmhc_tpu.diffusion.schedule import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion.schedule import ScheduleTables as JTables
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models import init_score_network
from pmhc_tpu.models import score_network_forward as j_score
from pmhc_tpu.models.import_torch import export_torch_checkpoint
from pmhc_tpu_torch.data import DeviceDataset
from pmhc_tpu_torch.data.realistic import realistic_packed
from pmhc_tpu_torch.diffusion import DiffusionConfig
from pmhc_tpu_torch.models import ScoreNetworkConfig
from pmhc_tpu_torch.models.import_params import load_checkpoint
from pmhc_tpu_torch.serve import batch_seed
from pmhc_tpu_torch.train import MetricsRecord, TrainConfig, Trainer, eval_step
from tests.test_torch_egnn import numpy_batch
from tests.test_torch_train import _batches, _noise_pair

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("backend,rtol", [("dense", 1e-5), ("fused", 5e-4)])
def test_eval_step_matches_jax(tmp_path, backend, rtol):
    params = jax.tree_util.tree_map(np.asarray, init_score_network(jax.random.key(3), JConfig()))
    path = str(tmp_path / "m.pth")
    export_torch_checkpoint(params, path)
    model = load_checkpoint(path)
    nb = numpy_batch(4, seed=12)
    jb, tb = _batches(nb)
    j_eps, t_eps = _noise_pair(8, 4)
    t = np.array([0, 999, 321, 640], np.int32)
    zt = j_add_noise(jb, j_eps, jnp.asarray(t), JTables(JDiffusionConfig()))
    pred = j_score(params, zt, jnp.asarray(t), JConfig())
    want = {k: float(jnp.sum(v)) for k, v in
            j_loss(j_eps, pred, jb["mask"], jb["torsions_mask"], 0.1, 1.0, 1.0).items()}
    got = eval_step(model, tb, torch.from_numpy(t), t_eps,
                    model_config=ScoreNetworkConfig(backend=backend))
    assert list(got) == list(want)
    for k, v in got.items():
        assert not v.requires_grad
        np.testing.assert_allclose(float(v), want[k], rtol=rtol, err_msg=k)
    assert all(p.grad is None for p in model.parameters())


def _trainer(**kw):
    cfg = TrainConfig(seed=7, nan_check_every=0, **kw)
    return Trainer(ScoreNetworkConfig(backend="fused", noise_step_count=8),
                   DiffusionConfig(noise_step_count=8), cfg, device="cpu")


def _state(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


def test_train_batches_equal_train_batch_calls():
    batches = [numpy_batch(3, seed=30 + k) for k in range(3)]
    a, b = _trainer(ema_decay=0.9), _trainer(ema_decay=0.9)
    ma, mb = MetricsRecord(), MetricsRecord()
    sums_a = a.train_batches(batches, ma)
    sums_b = [b.train_batch(x, mb) for x in batches]
    assert a.global_step == b.global_step == 3
    for x, y in zip(sums_a, sums_b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for k, v in _state(a).items():
        assert torch.equal(v, _state(b)[k]), k
    assert all(torch.equal(x, y) for x, y in zip(a.optimizer.ema, b.optimizer.ema))
    assert ma.mean() == mb.mean() and len(ma) == len(mb) == 9


def test_train_batches_on_device_dataset_batches_equal_packed_batches():
    """The ``--device-data`` route: batches gathered by a ``DeviceDataset``
    (``index_select`` on the device) through ``train_batches`` equal
    ``train_batch`` on the packed numpy batches."""
    packed = realistic_packed(7, seed=5)
    data = DeviceDataset(packed, CPU)
    idx = [[4, 0, 6], [2, 5, 1]]
    a, b = _trainer(), _trainer()
    ma, mb = MetricsRecord(), MetricsRecord()
    a.train_batches([data.get_batch(row) for row in idx], ma)
    for row in idx:
        b.train_batch(packed.get_batch(row), mb)
    for k, v in _state(a).items():
        assert torch.equal(v, _state(b)[k]), k
    assert ma.mean() == mb.mean()


def test_eval_batch_is_fixed_per_generator_and_takes_ema_params():
    """The same generator seed gives the same sums; no update happens;
    ``params`` evaluates other weights (the EMA) without touching the
    trained ones."""
    tr = _trainer(ema_decay=0.5)
    for k in range(2):
        tr.train_batch(numpy_batch(3, seed=40 + k))
    before = _state(tr)
    batch = numpy_batch(3, seed=50)
    gen = lambda: torch.Generator().manual_seed(batch_seed(104729, 0))  # noqa: E731
    m1, m2 = MetricsRecord(), MetricsRecord()
    s1 = tr.eval_batch(batch, gen(), m1)
    s2 = tr.eval_batch(batch, gen(), m2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1) and m1.mean() == m2.mean()
    assert all(torch.equal(v, before[k]) for k, v in _state(tr).items())
    ema = tr.eval_batch(batch, gen(), params=tr.ema_params)
    ref = _trainer()
    ref.model.load_state_dict(tr.ema_params)
    want = ref.eval_batch(batch, gen())
    assert all(torch.equal(ema[k], want[k]) for k in ema)
    assert not torch.equal(ema["total loss"], s1["total loss"])
    assert all(torch.equal(v, before[k]) for k, v in _state(tr).items())
