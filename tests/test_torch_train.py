"""The port's training step (``pmhc_tpu_torch/train``, ``add_noise``,
``diffusion_loss``) against the JAX package's, on the same numpy inputs,
weights, timesteps and noise.

Tolerances: ``add_noise`` and ``diffusion_loss`` 1e-6 (torsions after
``add_noise`` 3e-6: ``TORS_TOL``). A 3-step parity-f32
loss trajectory (two steps with one t per batch, one with a t per sample)
against a JAX step built as ``pmhc_tpu/train/trainer.py:183-205`` builds
it (xla backend, ``optax.adam``): losses within rtol 5e-4 through the loop
layer and 1e-5 through the dense layer; parameters loosely, within the
3 steps' Adam budget (Adam moves a parameter by up to ~lr per step
however small its gradient, so where a gradient is cancellation noise the
two frameworks drift by O(lr)). The optimizer's schedule, clipping,
accumulation and EMA against optax within 1e-6 relative; the metrics CSV
byte for byte; the ``.pth`` read by ``import_torch_checkpoint``.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmhc_tpu.diffusion.loss import diffusion_loss as j_loss
from pmhc_tpu.diffusion.noise import add_noise as j_add_noise
from pmhc_tpu.diffusion.schedule import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion.schedule import ScheduleTables as JTables
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models import score_network_forward as j_score
from pmhc_tpu.models.import_torch import import_torch_checkpoint
from pmhc_tpu.train.ema import ema_of_params, extract_ema_params
from pmhc_tpu.train.metrics import MetricsRecord as JMetrics
from pmhc_tpu.train.trainer import TrainConfig as JTrainConfig
from pmhc_tpu.train.trainer import make_learning_rate as j_make_lr
from pmhc_tpu_torch.data.synthetic import synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, add_noise, diffusion_loss
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.models import ScoreNetworkConfig
from pmhc_tpu_torch.models.import_params import params_to_numpy
from pmhc_tpu_torch.train import (
    Adam,
    CheckpointManager,
    MetricsRecord,
    TrainConfig,
    Trainer,
    make_learning_rate,
    train_step,
)
from tests.test_torch_egnn import jax_model_batch, numpy_batch, params_pair, torch_model_batch
from tests.test_torch_sampler import _noise_np

torch.set_num_threads(1)
LR = 1e-3
# the noised torsions go through arccos, sin and cos, whose last bits
# differ between the two libraries: measured 1.2e-6 on one element at
# t=517 (recorded as the test's JUnit property ``torsions_err``)
TORS_TOL = 3e-6


def _batches(nb):
    jb, tb = jax_model_batch(nb), torch_model_batch(nb)
    jb["torsions_mask"] = jnp.asarray(nb["torsions_mask"])
    tb["torsions_mask"] = torch.from_numpy(np.array(nb["torsions_mask"]))
    return jb, tb


def _noise_pair(seed, B):
    q, t, tor = (x[0] for x in _noise_np(np.random.default_rng(seed), 1, B))
    j = {"frames": JRigid(jnp.asarray(q), jnp.asarray(t)), "torsions": jnp.asarray(tor)}
    tt = {"frames": TRigid(torch.from_numpy(q), torch.from_numpy(t)), "torsions": torch.from_numpy(tor)}
    return j, tt


@pytest.mark.parametrize("t", [0, 517, np.array([3, 998, 250, 640], np.int32)])
def test_add_noise_matches_jax(t, record_property):
    nb = numpy_batch(4, seed=2)
    jb, tb = _batches(nb)
    j_eps, t_eps = _noise_pair(7, 4)
    j_out = j_add_noise(jb, j_eps, jnp.asarray(t), JTables(JDiffusionConfig()))
    t_t = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    t_out = add_noise(tb, t_eps, t_t, ScheduleTables(DiffusionConfig()))
    for a, b, tol in ((t_out["frames"].quats, j_out["frames"].quats, 1e-6),
                      (t_out["frames"].trans, j_out["frames"].trans, 1e-6),
                      (t_out["torsions"], j_out["torsions"], TORS_TOL)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=1e-6)
    record_property("torsions_err", float(np.abs(t_out["torsions"].numpy()
                                                 - np.asarray(j_out["torsions"])).max()))
    assert t_out["features"] is tb["features"]


def test_diffusion_loss_matches_jax():
    nb = numpy_batch(5, seed=3)
    nb["torsions_mask"][2, :4] = False
    jb, tb = _batches(nb)
    j_eps, t_eps = _noise_pair(1, 5)
    j_pred, t_pred = _noise_pair(2, 5)
    j_out = j_loss(j_eps, j_pred, jb["mask"], jb["torsions_mask"], 0.1, 1.0, 1.0)
    t_out = diffusion_loss(t_eps, t_pred, tb["mask"], tb["torsions_mask"], 0.1, 1.0, 1.0)
    assert list(t_out) == list(j_out)
    for k in j_out:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


STEP_TS = (999, np.array([5, 400, 812, 20], np.int32), 517)


@pytest.fixture(scope="module")
def jax_trajectory():
    """3 optax-Adam steps of the JAX package's step (xla backend) from
    ``params_pair()``'s weights: per-step loss sums and final params."""
    params, _ = params_pair()
    tables = JTables(JDiffusionConfig())
    opt = optax.adam(LR)
    config = JConfig()

    @jax.jit
    def step(p, o, batch, t, eps):
        def loss_fn(pp):
            zt = j_add_noise(batch, eps, t, tables)
            pred = j_score(pp, zt, t, config)
            losses = j_loss(eps, pred, batch["mask"], batch["torsions_mask"], 0.1, 1.0, 1.0)
            return jnp.sum(losses["total loss"]) / batch["mask"].shape[0], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, {k: jnp.sum(v) for k, v in losses.items()}

    o = opt.init(params)
    sums = []
    for k, t in enumerate(STEP_TS):
        jb, _ = _batches(numpy_batch(4, seed=20 + k))
        params, o, s = step(params, o, jb, jnp.asarray(t), _noise_pair(40 + k, 4)[0])
        sums.append({n: float(v) for n, v in s.items()})
    return sums, params


@pytest.mark.parametrize("backend,rtol", [("fused", 5e-4), ("dense", 1e-5)])
def test_train_step_trajectory_matches_jax(jax_trajectory, backend, rtol):
    j_sums, j_params = jax_trajectory
    _, model = params_pair()
    opt = Adam(list(model.parameters()), LR)
    for k, t in enumerate(STEP_TS):
        _, tb = _batches(numpy_batch(4, seed=20 + k))
        t_t = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
        sums = train_step(model, opt, tb, t_t, _noise_pair(40 + k, 4)[1],
                          model_config=ScoreNetworkConfig(backend=backend))
        for name, v in sums.items():
            np.testing.assert_allclose(float(v), j_sums[k][name], rtol=rtol, err_msg=f"{k} {name}")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(j_params)[0],
                            jax.tree_util.tree_leaves(params_to_numpy(model.state_dict()))):
        np.testing.assert_allclose(b, np.asarray(a), atol=3 * LR, err_msg=jax.tree_util.keystr(path))


SCHEDULES = [
    TrainConfig(),
    TrainConfig(lr_warmup_steps=3),
    TrainConfig(lr_decay_steps=6, lr_final=1e-4),
    TrainConfig(learning_rate=3e-3, lr_warmup_steps=2, lr_decay_steps=7, lr_final=5e-4),
]


def _j_config(cfg: TrainConfig) -> JTrainConfig:
    return JTrainConfig(**{f: getattr(cfg, f) for f in JTrainConfig.__dataclass_fields__})


@pytest.mark.parametrize("cfg", SCHEDULES)
def test_learning_rate_matches_optax(cfg):
    mine, theirs = make_learning_rate(cfg), j_make_lr(_j_config(cfg))
    if not callable(theirs):
        assert mine == theirs
        return
    for count in range(12):
        np.testing.assert_allclose(mine(count), float(theirs(count)), rtol=1e-6, atol=1e-10,
                                   err_msg=str(count))


@pytest.mark.parametrize("cfg", [
    TrainConfig(),
    TrainConfig(grad_clip_norm=0.5),
    TrainConfig(grad_accum=3, lr_warmup_steps=2, lr_decay_steps=5),
    TrainConfig(grad_clip_norm=2.0, grad_accum=2, ema_decay=0.9, lr_warmup_steps=1),
])
def test_optimizer_matches_optax(cfg):
    """Adam with clipping, accumulation and EMA, fed the same gradients
    as the JAX trainer's optax chain, step by step."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    parts = [optax.adam(j_make_lr(_j_config(cfg)))]
    if cfg.grad_clip_norm:
        parts.insert(0, optax.clip_by_global_norm(cfg.grad_clip_norm))
    if cfg.ema_decay:
        parts.append(ema_of_params(cfg.ema_decay))
    j_opt = parts[0] if len(parts) == 1 else optax.chain(*parts)
    if cfg.grad_accum > 1:
        j_opt = optax.MultiSteps(j_opt, every_k_schedule=cfg.grad_accum)
    j_p = [jnp.asarray(p) for p in p0]
    j_state = j_opt.init(j_p)
    t_p = [torch.from_numpy(p.copy()) for p in p0]
    opt = Adam(t_p, make_learning_rate(cfg), cfg.grad_clip_norm, cfg.grad_accum, cfg.ema_decay)
    for step in range(9):
        g = [(rng.normal(size=s) * (3.0 if step % 2 else 0.1)).astype(np.float32) for s in shapes]
        upd, j_state = j_opt.update([jnp.asarray(x) for x in g], j_state, j_p)
        j_p = optax.apply_updates(j_p, upd)
        opt.step([torch.from_numpy(x) for x in g])
        for a, b in zip(t_p, j_p):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=str(step))
    if cfg.ema_decay:
        for a, b in zip(opt.ema, extract_ema_params(j_state)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert opt.count == 9 // cfg.grad_accum


def test_metrics_csv_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    names = ("rmsd", "total loss", "positions loss", "rotations loss", "torsions loss")
    paths = (tmp_path / "jax.csv", tmp_path / "torch.csv")
    for epoch in range(2):
        j_rec, t_rec = JMetrics(), MetricsRecord()
        for _ in range(3):
            sums = {k: np.float32(rng.uniform(0, 50)) for k in names}
            j_rec.add_batch({k: jnp.asarray(v) for k, v in sums.items()}, 4)
            t_rec.add_batch({k: torch.tensor(v) for k, v in sums.items()}, 4)
        assert len(t_rec) == len(j_rec) == 12 and not t_rec.has_nan()
        j_rec.save(str(paths[0]), epoch)
        t_rec.save(str(paths[1]), epoch)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert next(csv.reader(open(paths[1])))[:2] == ["epoch", "total loss"]


def test_trainer_pth_read_by_import_torch_checkpoint(tmp_path):
    tr = Trainer(train_config=TrainConfig(seed=2), device="cpu")
    path = str(tmp_path / "model.pth")
    tr.save(path)
    tr.train_batch(synthetic_batch(batch_size=2, seed=1))
    tr.save(path)  # overwrites
    got = import_torch_checkpoint(path)
    want = params_to_numpy(tr.model.state_dict())
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(p))


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """Weights, Adam moments, EMA, both generators and the step come back:
    a restored trainer takes the same next step as the one that saved."""
    cfg = TrainConfig(seed=3, ema_decay=0.99, lr_warmup_steps=2)
    dc = DiffusionConfig(t_per_batch=False)
    a = Trainer(ScoreNetworkConfig(backend="auto"), dc, cfg, device="cpu")
    for k in range(2):
        a.train_batch(synthetic_batch(batch_size=2, seed=k))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(a.global_step, a.checkpoint_state())
    nxt = synthetic_batch(batch_size=2, seed=9)
    sums_a = a.train_batch(nxt)
    b = Trainer(ScoreNetworkConfig(backend="auto"), dc, TrainConfig(seed=7, ema_decay=0.99,
                                                                    lr_warmup_steps=2), device="cpu")
    b.load_checkpoint_state(mgr.restore())
    assert b.global_step == 2
    sums_b = b.train_batch(nxt)
    assert float(sums_a["total loss"]) == float(sums_b["total loss"])
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for name, v in a.ema_params.items():
        torch.testing.assert_close(v, b.ema_params[name], rtol=0, atol=0)
    for step in (3, 4, 5):
        mgr.save(step, a.checkpoint_state())
    assert mgr.steps() == [4, 5] and mgr.latest_step() == 5


def test_nan_loss_aborts_at_the_check():
    tr = Trainer(train_config=TrainConfig(nan_check_every=2), device="cpu")
    with torch.no_grad():
        tr.model.gnn2.translation_mlp[2].bias.fill_(float("nan"))
    tr.train_batch(synthetic_batch(batch_size=2, seed=0))  # step 1: not checked
    with pytest.raises(RuntimeError, match="NaN loss"):
        tr.train_batch(synthetic_batch(batch_size=2, seed=1))


def test_trainer_cpu_smoke_batch64_full_width():
    """Two steps at batch 64 and the published widths through the loop
    layer (its plain version on the CPU), one t per batch."""
    tr = Trainer(ScoreNetworkConfig(backend="auto"), train_config=TrainConfig(seed=1), device="cpu")
    assert sum(p.numel() for p in tr.model.parameters()) == 79195
    metrics = MetricsRecord()
    before = [p.detach().clone() for p in tr.model.parameters()]
    for k in range(2):
        sums = tr.train_batch(synthetic_batch(batch_size=64, seed=k), metrics)
        assert all(torch.isfinite(v) for v in sums.values())
    assert len(metrics) == 128 and tr.global_step == 2 and tr.optimizer.count == 2
    moved = [float((p.detach() - q).abs().max()) for p, q in zip(tr.model.parameters(), before)]
    assert max(moved) > 0.5 * LR
