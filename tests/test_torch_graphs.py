"""The step bodies that the port's CUDA graphs capture and replay on the
card (``utils/graphs.py``), run eagerly on the CPU against the JAX
package, and the switch that keeps graphs off the CPU.

- The reverse chain's device tables (``schedule.step_tables``) equal the
  JAX package's ``ScheduleTables`` (as ``remove_noise`` reads them) and
  ``StridedTables.scalars`` exactly, and the port's own ``scalars``;
  ``beta_alpha_sigma`` on an index tensor gathers the JAX tables' values
  exactly.
- The learning-rate schedule in tensor ops, on float32 count tensors,
  equals optax's within 1e-6 relative (``test_torch_train.py``'s
  tolerance), and the optimizer driven as the train graphs drive it
  (``updates_next``, ``apply_``, ``advance``; ``reset_`` and
  ``load_state_dict`` in place) equals optax's chain within 1e-6 relative.
- ``Trainer.train_indices`` on a ``DeviceDataset`` equals ``train_batch``
  calls on the batches it gathers, exactly (the same body on the same
  values).
- The card's graphed-vs-eager training check (``chip_smoke``'s
  ``change_errors`` / ``change_close`` at ``GRAPH_TRAIN_TOL``) passes a
  trainer held against its own repeat, and fails one that dropped its last
  update or stepped at half the learning rate.
- ``sample`` leaves its input batch as it was and repeats itself exactly
  for the same generator state.
- ``graphs=True`` on a CPU device raises, for the sampler, the service and
  the trainer; ``GraphCache`` drops its least recently used entry.
"""

import jax.numpy as jnp
from chip_smoke import change_close, change_errors, trainer_state
import numpy as np
import optax
import pytest
import torch

from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion import ScheduleTables as JTables
from pmhc_tpu.diffusion import StridedTables as JStrided
from pmhc_tpu.diffusion import strided_timesteps as j_strided
from pmhc_tpu.train.ema import ema_of_params, extract_ema_params
from pmhc_tpu.train.trainer import make_learning_rate as j_make_lr
from pmhc_tpu_torch.data import DeviceDataset
from pmhc_tpu_torch.data.realistic import realistic_packed
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, sample
from pmhc_tpu_torch.diffusion.schedule import step_tables
from pmhc_tpu_torch.models import ScoreNetworkConfig
from pmhc_tpu_torch.serve import SamplerService
from pmhc_tpu_torch.train import Adam, MetricsRecord, TrainConfig, Trainer, make_learning_rate
from pmhc_tpu_torch.utils.graphs import GraphCache, use_graphs
from tests.test_torch_egnn import params_pair, torch_model_batch
from tests.test_torch_sampler import _inputs
from tests.test_torch_train import SCHEDULES, _j_config

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("T,num_steps", [(1000, None), (1000, 37), (16, 5), (16, 16)])
def test_step_tables_equal_jax_tables(T, num_steps):
    cfg, j_cfg = DiffusionConfig(noise_step_count=T), JDiffusionConfig(noise_step_count=T)
    ts, sched = step_tables(cfg, num_steps)
    assert ts.dtype == np.int64 and sched.dtype == np.float32 and sched.shape == (len(ts), 6)
    if num_steps is None or num_steps == T:
        np.testing.assert_array_equal(ts, np.arange(T, 0, -1))
        j, mine = JTables(j_cfg), ScheduleTables(cfg)
        want = np.stack([np.asarray(x) for x in (
            j.beta[ts], j.sigma[ts], j.beta[ts - 1], j.alpha_ts[ts], j.sqr_sigma_ts[ts],
            j.sigma_t2s[ts])], axis=-1)
        np.testing.assert_array_equal(sched, np.array([mine.scalars(int(t)) for t in ts],
                                                       np.float32))
    else:
        j_ts = np.asarray(j_strided(T, num_steps))
        np.testing.assert_array_equal(ts, j_ts[:-1])
        j_st = JStrided(j_cfg, j_ts)
        want = np.array([[np.asarray(x) for x in j_st.scalars(k)] for k in range(len(ts))],
                        np.float32)
    np.testing.assert_array_equal(sched, want)


def test_beta_alpha_sigma_gathers_the_jax_tables_on_index_tensors():
    tab, j_tab = ScheduleTables(DiffusionConfig()), JTables(JDiffusionConfig())
    t = np.array([0, 999, 3, 517, 3], np.int64)
    for idx in (torch.from_numpy(t), torch.tensor(517)):
        got = tab.beta_alpha_sigma(idx)
        want = j_tab.beta_alpha_sigma(jnp.asarray(idx.numpy()))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == idx.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cfg", SCHEDULES)
def test_learning_rate_on_count_tensors_matches_optax(cfg):
    """The schedule as the optimizer evaluates it: a float32 count tensor in,
    a tensor out."""
    mine, theirs = make_learning_rate(cfg), j_make_lr(_j_config(cfg))
    if not callable(theirs):
        assert mine == theirs
        return
    for count in range(12):
        got = mine(torch.tensor(float(count)))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), float(theirs(count)), rtol=1e-6, atol=1e-10,
                                   err_msg=str(count))


def test_optimizer_driven_as_the_graphs_drive_it_matches_optax():
    """Accumulation over 2, clipping, warmup then cosine, EMA: each
    micro-batch as ``apply_`` with the host's ``updates_next`` /
    ``advance``; a ``reset_`` and a ``load_state_dict`` halfway keep every
    state tensor where it was (a captured step keeps reading them)."""
    cfg = TrainConfig(grad_clip_norm=1.0, grad_accum=2, ema_decay=0.9, lr_warmup_steps=2,
                      lr_decay_steps=6, lr_final=1e-4)
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def j_opt():
        chain = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                            optax.adam(j_make_lr(_j_config(cfg))), ema_of_params(cfg.ema_decay))
        return optax.MultiSteps(chain, every_k_schedule=cfg.grad_accum)

    j = j_opt()
    j_p = [jnp.asarray(p) for p in p0]
    j_state = j.init(j_p)
    t_p = [torch.from_numpy(p.copy()) for p in p0]
    opt = Adam(t_p, make_learning_rate(cfg), cfg.grad_clip_norm, cfg.grad_accum, cfg.ema_decay)
    state_ptrs = [x.data_ptr() for x in opt.mu + opt.nu + opt.acc + opt.ema
                  + [opt.count_t, opt.mini_t]]
    saved = None
    for step in range(14):
        if step == 8:  # restart both from scratch, in place on the torch side
            j = j_opt()
            j_state = j.init(j_p)
            opt.reset_()
            saved = {k: (v if not isinstance(v, list) else [x.clone() for x in v])
                     for k, v in opt.state_dict().items()}
        g = [(rng.normal(size=s) * (4.0 if step % 3 else 0.2)).astype(np.float32) for s in shapes]
        upd, j_state = j.update([jnp.asarray(x) for x in g], j_state, j_p)
        j_p = optax.apply_updates(j_p, upd)
        update = opt.updates_next
        assert update == (step % 2 == 1)
        opt.apply_([torch.from_numpy(x) for x in g], update)
        opt.advance(update)
        for a, b in zip(t_p, j_p):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7,
                                       err_msg=str(step))
    for a, b in zip(opt.ema, extract_ema_params(j_state.inner_opt_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert opt.count == 3
    opt.load_state_dict(saved)
    assert opt.count == 0 and opt.mini_step == 0
    assert [x.data_ptr() for x in opt.mu + opt.nu + opt.acc + opt.ema
            + [opt.count_t, opt.mini_t]] == state_ptrs


def _trainer(**kw):
    return Trainer(ScoreNetworkConfig(backend="fused", noise_step_count=8),
                   DiffusionConfig(noise_step_count=8, t_per_batch=False),
                   TrainConfig(seed=5, nan_check_every=2, **kw), device="cpu")


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2, "ema_decay": 0.9}], ids=["adam", "accum2_ema"])
def test_train_indices_equal_train_batch_calls(kw):
    """K = 3 steps on a [3, 4] index matrix over a CPU ``DeviceDataset``
    against 3 ``train_batch`` calls on ``get_batch`` of each row, one
    timestep per sample: the same sums, weights, optimizer state and
    metrics, exactly."""
    data = DeviceDataset(realistic_packed(12, seed=8), CPU)
    idx = np.random.default_rng(2).permutation(12).reshape(3, 4)
    a, b = _trainer(**kw), _trainer(**kw)
    ma, mb = MetricsRecord(), MetricsRecord()
    sums_a = a.train_indices(data, idx, ma)
    sums_b = [b.train_batch(data.get_batch(list(row)), mb) for row in idx]
    assert a.global_step == b.global_step == 3
    for x, y in zip(sums_a, sums_b):
        assert all(torch.equal(x[k], y[k]) for k in y)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"] and sa["mini_step"] == sb["mini_step"]
    for name in ("mu", "nu", "acc", "ema"):
        assert (sa[name] is None) == (sb[name] is None)
        assert sa[name] is None or all(torch.equal(x, y) for x, y in zip(sa[name], sb[name]))
    assert ma.mean() == mb.mean() and len(ma) == len(mb) == 12
    with pytest.raises(ValueError, match=r"\[K, B\]"):
        a.train_indices(data, idx[0])


@pytest.mark.parametrize("fault", ["none", "last_update_dropped", "half_lr"])
def test_training_check_holds_the_parameters_change(fault):
    """3 steps against the same 3 steps from one seed: the same run passes;
    a run that drops its last update, or steps at half the learning rate,
    reads a change ~1/3 and ~1/2 away from the reference's and fails."""
    data = DeviceDataset(realistic_packed(12, seed=8), CPU)
    batches = [data.get_batch(list(row)) for row in np.arange(12).reshape(3, 4)]
    want = _trainer(ema_decay=0.9)
    start = trainer_state(want)
    for b in batches:
        want.train_batch(b)
    got = _trainer(ema_decay=0.9, learning_rate=5e-4 if fault == "half_lr" else 1e-3)
    for b in batches[:2] if fault == "last_update_dropped" else batches:
        got.train_batch(b)
    err = change_errors(start, trainer_state(got), trainer_state(want))
    assert err["got_moved"] > 0 and err["want_moved"] > 0
    if fault == "none":
        assert err["rel"] == 0 and change_close(err)
    else:
        assert err["rel"] > 0.2 and not change_close(err), err


def test_sample_leaves_its_batch_and_repeats_exactly():
    """The chain updates its own copy of the state in place: the input batch
    is untouched, and the same generator state gives the same trajectory."""
    _, model = params_pair(seed=2)
    nb, _, _ = _inputs(4)
    batch = torch_model_batch(nb)
    before = (batch["frames"].quats.clone(), batch["frames"].trans.clone(),
              batch["torsions"].clone())
    cfg = DiffusionConfig(noise_step_count=4)
    mc = ScoreNetworkConfig(noise_step_count=4, backend="auto")
    runs = [sample(model, batch, cfg, mc, generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    for x, y in zip(before, (batch["frames"].quats, batch["frames"].trans, batch["torsions"])):
        assert torch.equal(x, y)
    assert torch.equal(runs[0]["frames"].quats, runs[1]["frames"].quats)
    assert torch.equal(runs[0]["torsions"], runs[1]["torsions"])
    assert not torch.equal(runs[0]["frames"].trans, batch["frames"].trans)


def test_graphs_on_a_cpu_device_raise():
    assert use_graphs(None, CPU) is False and use_graphs(False, CPU) is False
    assert use_graphs(None, torch.device("cuda")) is True
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        use_graphs(True, CPU)
    _, model = params_pair(seed=2)
    nb, _, t_inj = _inputs(4)
    cfg = DiffusionConfig(noise_step_count=4)
    mc = ScoreNetworkConfig(noise_step_count=4, backend="auto")
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        sample(model, torch_model_batch(nb), cfg, mc, generator=torch.Generator(), graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        sample(model, torch_model_batch(nb), cfg, mc, injected_noise=t_inj, graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        SamplerService(model, batch_size=2, noise_step_count=4, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Trainer(device="cpu", graphs=True)
    assert not SamplerService(model, batch_size=2, noise_step_count=4, device="cpu").graphs
    assert not Trainer(device="cpu").graphs


def test_graph_cache_drops_the_least_recently_used():
    cache = GraphCache(max_entries=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1  # "b" is now the least recently used
    cache.put("c", 3)
    assert cache.get("b") is None and cache.get("a") == 1 and cache.get("c") == 3
    assert len(cache) == 2
    cache.clear()
    assert len(cache) == 0
