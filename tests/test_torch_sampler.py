"""The port's sampler against the JAX package's: with the same injected
per-step noise (numpy, handed to both), the fused-backend trajectory
matches ``sample_lane`` (interpret mode) and the dense-backend trajectory
matches the generic ``sample`` (xla), over T=4 and over the strided K=2
of T=4. Tolerances are those of ``tests/unit/test_sampler_lane.py``:
quats 2e-4, translations 1e-3, torsions 2e-4. The bf16 mode is held
against the g8 bf16 sampler with the looser tolerances stated there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion import sample as j_sample
from pmhc_tpu.diffusion import strided_timesteps as j_strided
from pmhc_tpu.diffusion.sampler_lane import sample_lane
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu_torch.diffusion import DiffusionConfig, ScheduleTables, sample, strided_timesteps
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.models import ScoreNetworkConfig
from tests.test_torch_egnn import jax_model_batch, numpy_batch, params_pair, torch_model_batch

torch.set_num_threads(1)
T_STEPS = 4


def _noise_np(rng, lead, B, N=16):
    """Noise of gen_noise's form drawn with numpy: [lead, B, N] frames and torsions."""
    x = rng.uniform(size=(lead, B, N, 3))
    r1, r2 = np.sqrt(1 - x[..., 0]), np.sqrt(x[..., 0])
    th1, th2 = 2 * np.pi * x[..., 1], 2 * np.pi * x[..., 2]
    quats = np.stack((r2 * np.cos(th2), r1 * np.sin(th1), r1 * np.cos(th1), r2 * np.sin(th2)), -1)
    trans = rng.normal(size=(lead, B, N, 3)) * 5.0
    a = rng.uniform(size=(lead, B, N, 7)) * 2 * np.pi
    tors = np.stack((np.sin(a), np.cos(a)), -1)
    f = lambda v: v.astype(np.float32)
    return f(quats), f(trans), f(tors)


def _inputs(num_jumps, B=3):
    rng = np.random.default_rng(21)
    nb = numpy_batch(B, seed=5)
    q0, t0, tor0 = (x[0] for x in _noise_np(rng, 1, B))
    nb["frames"] = np.concatenate((q0, t0), -1)
    nb["torsions"] = tor0
    q, t, tor = _noise_np(rng, num_jumps, B)
    j_inj = {"frames": JRigid(jnp.asarray(q), jnp.asarray(t)), "torsions": jnp.asarray(tor)}
    t_inj = {"frames": TRigid(torch.from_numpy(q), torch.from_numpy(t)),
             "torsions": torch.from_numpy(tor)}
    return nb, j_inj, t_inj


def _assert_traj_close(t_out, j_out):
    np.testing.assert_allclose(t_out["frames"].quats.numpy(),
                               np.asarray(j_out["frames"].quats), atol=2e-4)
    np.testing.assert_allclose(t_out["frames"].trans.numpy(),
                               np.asarray(j_out["frames"].trans), atol=1e-3)
    np.testing.assert_allclose(t_out["torsions"].numpy(),
                               np.asarray(j_out["torsions"]), atol=2e-4)


@pytest.mark.parametrize("num_steps", [None, 2])
def test_fused_sampler_matches_sample_lane(num_steps):
    params, model = params_pair(seed=2)
    n_jumps = T_STEPS if num_steps is None else len(j_strided(T_STEPS, num_steps)) - 1
    nb, j_inj, t_inj = _inputs(n_jumps)
    j_cfg = JDiffusionConfig(noise_step_count=T_STEPS)
    j_out = sample_lane(
        params, jax_model_batch(nb), jax.random.key(0), j_cfg,
        JConfig(noise_step_count=T_STEPS, backend="pallas_lane", lane_block=128),
        injected_noise=j_inj, interpret=True, num_steps=num_steps)
    t_out = sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
                   ScoreNetworkConfig(noise_step_count=T_STEPS, backend="auto"),
                   injected_noise=t_inj, num_steps=num_steps)
    _assert_traj_close(t_out, j_out)


@pytest.mark.parametrize("num_steps", [None, 2])
def test_bf16_sampler_matches_sample_lane_g8_bf16(num_steps):
    """The bf16 mode against ``sample_lane(precision=None, g8=True)``, the
    ``--bf16`` path. JAX's CPU backend runs the DEFAULT-precision XLA
    projections in fp32 where the port takes one bf16 pass, so the two
    differ by bf16 rounding: measured <= 3.6e-3 at this size; tolerances
    quats 2e-2, translations 2e-2, torsions 5e-3."""
    params, model = params_pair(seed=2)
    n_jumps = T_STEPS if num_steps is None else len(j_strided(T_STEPS, num_steps)) - 1
    nb, j_inj, t_inj = _inputs(n_jumps)
    j_out = sample_lane(
        params, jax_model_batch(nb), jax.random.key(0), JDiffusionConfig(noise_step_count=T_STEPS),
        JConfig(noise_step_count=T_STEPS, backend="g8", lane_block=128), precision=None,
        injected_noise=j_inj, interpret=True, num_steps=num_steps, g8=True)
    t_out = sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
                   ScoreNetworkConfig(noise_step_count=T_STEPS, backend="g8"), bf16=True,
                   injected_noise=t_inj, num_steps=num_steps)
    q = t_out["frames"].quats.numpy()
    np.testing.assert_allclose(q, np.asarray(j_out["frames"].quats), atol=2e-2)
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(t_out["frames"].trans.numpy(),
                               np.asarray(j_out["frames"].trans), atol=2e-2)
    np.testing.assert_allclose(t_out["torsions"].numpy(), np.asarray(j_out["torsions"]), atol=5e-3)


def test_dense_sampler_matches_generic_sample():
    params, model = params_pair(seed=2)
    nb, j_inj, t_inj = _inputs(T_STEPS)
    j_out = j_sample(params, jax_model_batch(nb), jax.random.key(0),
                     JDiffusionConfig(noise_step_count=T_STEPS),
                     JConfig(noise_step_count=T_STEPS), injected_noise=j_inj)
    t_out = sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
                   ScoreNetworkConfig(noise_step_count=T_STEPS, backend="dense"),
                   injected_noise=t_inj)
    _assert_traj_close(t_out, j_out)


def test_schedule_tables_match_jax():
    from pmhc_tpu.diffusion import ScheduleTables as JTables
    from pmhc_tpu.diffusion import StridedTables as JStrided
    from pmhc_tpu_torch.diffusion import StridedTables

    cfg, j_cfg = DiffusionConfig(), JDiffusionConfig()
    tab, j_tab = ScheduleTables(cfg), JTables(j_cfg)
    for name in ("beta", "alpha", "sigma", "alpha_ts", "sqr_sigma_ts", "sigma_ts", "sigma_t2s"):
        np.testing.assert_array_equal(getattr(tab, name), np.asarray(getattr(j_tab, name)))
    ts = strided_timesteps(1000, 37)
    np.testing.assert_array_equal(ts, np.asarray(j_strided(1000, 37)))
    st, j_st = StridedTables(cfg, ts), JStrided(j_cfg, ts)
    for k in (0, 5, st.num_jumps - 1):
        np.testing.assert_array_equal(np.array(st.scalars(k), np.float32),
                                      np.array([np.asarray(x) for x in j_st.scalars(k)]))


@pytest.mark.parametrize("t", [1, 500, 1000])
def test_remove_noise_matches_jax(t):
    """One reverse step on numpy (noised, predicted, random) states."""
    from pmhc_tpu.diffusion import ScheduleTables as JTables
    from pmhc_tpu.diffusion.noise import remove_noise as j_remove_noise
    from pmhc_tpu_torch.diffusion import remove_noise

    q, tr, tor = _noise_np(np.random.default_rng(t), 3, 2)
    j = [{"frames": JRigid(jnp.asarray(q[i]), jnp.asarray(tr[i])), "torsions": jnp.asarray(tor[i])}
         for i in range(3)]
    o = [{"frames": TRigid(torch.from_numpy(q[i]), torch.from_numpy(tr[i])),
          "torsions": torch.from_numpy(tor[i])} for i in range(3)]
    _assert_traj_close(remove_noise(*o, t, ScheduleTables(DiffusionConfig())),
                       j_remove_noise(*j, t, t - 1, JTables(JDiffusionConfig())))


def test_own_generator_run_is_finite_and_unit():
    _, model = params_pair(seed=3)
    nb, _, _ = _inputs(1)
    out = sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
                 ScoreNetworkConfig(noise_step_count=T_STEPS, backend="auto"),
                 generator=torch.Generator().manual_seed(9))
    q = out["frames"].quats.numpy()
    assert np.isfinite(q).all() and np.isfinite(out["torsions"].numpy()).all()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-3)
    with pytest.raises(ValueError):
        sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
               ScoreNetworkConfig(noise_step_count=T_STEPS))
