"""The rest of ``pmhc_tpu_torch.geometry`` against ``pmhc_tpu.geometry`` on
the same numpy inputs (atol 1e-6 plus rtol 1e-6: one fp32 ulp of a
translation near 10 is 1e-6): ``quat_rotate``,
``rot_to_quat`` (random and degenerate rotations, and the numpy form the
data package uses), ``random_quat`` / ``random_sin_cos`` (unit norm, the
Shoemake moments, the draws ``gen_noise`` makes), ``spherical_to_quat``,
``quat_multiply_by_vec``, ``get_quat_angle``, ``angle_to_sin_cos``,
``get_sin_cos_angle``, every ``RigidArray`` method, ``get_rmsd`` and
``compute_fape``, and the three FAPE properties of
``tests/unit/test_fape.py``."""

import math

import jax  # noqa: F401  (the tier's convention: both frameworks importable)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pmhc_tpu.geometry as jg
import pmhc_tpu_torch.geometry as tg
from pmhc_tpu_torch.data.synthetic import rot_to_quat_np

torch.set_num_threads(1)
ATOL = 1e-6


def _quats(rng, shape=(64,)):
    q = rng.normal(size=tuple(shape) + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rigid_np(rng, shape=(8,), scale=5.0):
    return _quats(rng, shape), (rng.normal(size=tuple(shape) + (3,)) * scale).astype(np.float32)


def _pair(q, t):
    return (tg.RigidArray(torch.from_numpy(q), torch.from_numpy(t)),
            jg.RigidArray(jnp.asarray(q), jnp.asarray(t)))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=1e-6)


def _rigid_close(rt, rj, atol=ATOL):
    _close(rt.quats, rj.quats, atol)
    _close(rt.trans, rj.trans, atol)


def test_geometry_exports_every_jax_name():
    assert set(jg.__all__) <= set(tg.__all__)
    assert set(tg.__all__) - set(jg.__all__) == {"identity_quat"}
    for name in tg.__all__:
        assert getattr(tg, name) is not None


def test_quat_rotate_and_multiply_by_vec_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)  # non-unit: |q|^2 scaling kept
    v = rng.normal(size=(64, 3)).astype(np.float32)
    _close(tg.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)),
           jg.quat_rotate(jnp.asarray(q), jnp.asarray(v)))
    _close(tg.quat_multiply_by_vec(torch.from_numpy(q), torch.from_numpy(v)),
           jg.quat_multiply_by_vec(jnp.asarray(q), jnp.asarray(v)))
    # rotating by a unit quat is R(q) @ v
    qu = torch.from_numpy(_quats(rng))
    vt = torch.from_numpy(v)
    np.testing.assert_allclose(tg.quat_rotate(qu, vt).numpy(),
                               torch.einsum("nij,nj->ni", tg.quat_to_rot(qu), vt).numpy(), atol=1e-5)


def _degenerate_mats():
    """180-degree turns about each axis and the identity: all four Shepperd branches."""
    mats = []
    for axis in range(3):
        m = -np.eye(3)
        m[axis, axis] = 1.0
        mats.append(m)
    mats.append(np.eye(3))
    return np.stack(mats).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_rot_to_quat_matches_jax_and_numpy(case):
    if case == "random":
        m = np.array(jg.quat_to_rot(jnp.asarray(_quats(np.random.default_rng(1), (256,)))))
    else:
        m = _degenerate_mats()
    got = tg.rot_to_quat(torch.from_numpy(m))
    _close(got, jg.rot_to_quat(jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), rot_to_quat_np(m), atol=ATOL)
    assert (got[..., 0] >= 0).all()
    np.testing.assert_allclose(tg.quat_to_rot(got).numpy(), m, atol=1e-5)


def test_random_quat_is_unit_and_uniform():
    q = tg.random_quat(torch.Generator().manual_seed(0), (10, 10))
    assert q.shape == (10, 10, 4) and q.dtype == torch.float32
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    # uniform on S^3: E[q] = 0, E[q_i^2] = 1/4
    q = tg.random_quat(torch.Generator().manual_seed(9), (20000,))
    assert torch.all(q.mean(0).abs() < 0.02)
    np.testing.assert_allclose((q * q).mean(0).numpy(), 0.25, atol=0.01)


def test_random_sin_cos_is_unit_and_uniform():
    sc = tg.random_sin_cos(torch.Generator().manual_seed(8), (100, 7))
    assert sc.shape == (100, 7, 2)
    np.testing.assert_allclose((sc * sc).sum(-1).numpy(), 1.0, atol=1e-5)
    # uniform angles: E[sin] = E[cos] = 0, E[sin^2] = 1/2
    sc = tg.random_sin_cos(torch.Generator().manual_seed(10), (20000,))
    assert torch.all(sc.mean(0).abs() < 0.02)
    np.testing.assert_allclose((sc * sc).mean(0).numpy(), 0.5, atol=0.01)


def test_gen_noise_draws_through_random_quat_and_random_sin_cos():
    """gen_noise's draws are exactly randn, then random_quat, then
    random_sin_cos from one generator (the sampler's trajectories rest on it)."""
    from pmhc_tpu_torch.diffusion import DiffusionConfig, gen_noise

    cfg = DiffusionConfig()
    noise = gen_noise(torch.Generator().manual_seed(3), (5, 16), cfg)
    g = torch.Generator().manual_seed(3)
    trans = torch.randn((5, 16, 3), generator=g) * cfg.position_noise_scale
    assert torch.equal(noise["frames"].trans, trans)
    assert torch.equal(noise["frames"].quats, tg.random_quat(g, (5, 16)))
    assert torch.equal(noise["torsions"], tg.random_sin_cos(g, (5, 16, 7)))


def test_spherical_and_angle_functions_match_jax():
    rng = np.random.default_rng(2)
    phi, theta, alpha = (rng.uniform(-math.pi, math.pi, size=(64,)).astype(np.float32)
                         for _ in range(3))
    got = tg.spherical_to_quat(*(torch.from_numpy(x) for x in (phi, theta, alpha)))
    _close(got, jg.spherical_to_quat(*(jnp.asarray(x) for x in (phi, theta, alpha))))
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    a = rng.uniform(-math.pi, math.pi, size=(64,)).astype(np.float32)
    _close(tg.angle_to_sin_cos(torch.from_numpy(a)), jg.angle_to_sin_cos(jnp.asarray(a)))
    # angles kept away from 0 and pi, where arccos amplifies one ulp
    q1, q2 = _quats(rng), _quats(rng)
    _close(tg.get_quat_angle(torch.from_numpy(q1), torch.from_numpy(q2)),
           jg.get_quat_angle(jnp.asarray(q1), jnp.asarray(q2)))
    b1, b2 = (rng.uniform(0.1, 3.0, size=(64,)) for _ in range(2))
    s1 = np.stack((np.sin(b1), np.cos(b1)), -1).astype(np.float32) * 1.7
    s2 = np.stack((np.sin(-b2), np.cos(-b2)), -1).astype(np.float32)
    _close(tg.get_sin_cos_angle(torch.from_numpy(s1), torch.from_numpy(s2)),
           jg.get_sin_cos_angle(jnp.asarray(s1), jnp.asarray(s2)))
    # 90 degrees about z: the half-angle metric gives pi / 4
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    qz = torch.tensor([math.cos(math.pi / 4), 0.0, 0.0, math.sin(math.pi / 4)])
    assert abs(float(tg.get_quat_angle(ident, qz)) - math.pi / 4) < 1e-6


def test_rigid_algebra_matches_jax():
    rng = np.random.default_rng(3)
    a_t, a_j = _pair(*_rigid_np(rng))
    b_t, b_j = _pair(*_rigid_np(rng))
    p = rng.normal(size=(8, 3)).astype(np.float32) * 5
    q = _quats(rng, (8,))
    _rigid_close(a_t.compose(b_t), a_j.compose(b_j))
    _rigid_close(a_t.compose_rotation(torch.from_numpy(q)), a_j.compose_rotation(jnp.asarray(q)))
    _rigid_close(a_t.invert(), a_j.invert())
    _close(a_t.apply(torch.from_numpy(p)), a_j.apply(jnp.asarray(p)))
    _close(a_t.invert_apply(torch.from_numpy(p)), a_j.invert_apply(jnp.asarray(p)))
    # non-unit quats: normalize, and invert / invert_apply normalize first
    c_t, c_j = _pair(rng.normal(size=(8, 4)).astype(np.float32) * 2, _rigid_np(rng)[1])
    _rigid_close(c_t.normalize(), c_j.normalize())
    _rigid_close(c_t.invert(), c_j.invert())
    # the properties of tests/unit/test_geometry.py::TestRigidArray
    pt = torch.from_numpy(p)
    np.testing.assert_allclose(a_t.compose(b_t).apply(pt).numpy(),
                               a_t.apply(b_t.apply(pt)).numpy(), atol=1e-4)
    np.testing.assert_allclose(a_t.invert().apply(a_t.apply(pt)).numpy(), p, atol=1e-4)


def test_rigid_constructors_and_structure_match_jax():
    rng = np.random.default_rng(4)
    ident_t, ident_j = tg.RigidArray.identity((3, 4)), jg.RigidArray.identity((3, 4))
    _rigid_close(ident_t, ident_j, 0)
    assert tuple(ident_t.shape) == (3, 4) and ident_t.dtype == torch.float32
    np.testing.assert_array_equal(ident_t.apply(torch.ones(3, 4, 3)).numpy(), 1.0)
    a_t, a_j = _pair(*_rigid_np(rng, (6, 5)))
    _close(a_t.to_tensor_4x4(), a_j.to_tensor_4x4())
    m = np.array(a_j.to_tensor_4x4())
    _rigid_close(tg.RigidArray.from_tensor_4x4(torch.from_numpy(m)),
                 jg.RigidArray.from_tensor_4x4(jnp.asarray(m)))
    for idx in (2, (slice(1, 4), 0), (slice(None), 3)):
        _rigid_close(a_t[idx], a_j[idx], 0)
    _rigid_close(a_t.reshape((30,)), a_j.reshape((30,)), 0)
    b_t, b_j = _pair(*_rigid_np(rng, (6, 5)))
    for axis in (0, 1, -1):
        _rigid_close(tg.RigidArray.cat([a_t, b_t], axis), jg.RigidArray.cat([a_j, b_j], axis), 0)


def test_get_rmsd_matches_jax():
    rng = np.random.default_rng(5)
    a_t, a_j = _pair(*_rigid_np(rng, (4, 16)))
    b_t, b_j = _pair(*_rigid_np(rng, (4, 16)))
    got = tg.get_rmsd(a_t, b_t)
    assert got.shape == (4,)
    _close(got, jg.get_rmsd(a_j, b_j))
    assert torch.all(tg.get_rmsd(a_t, a_t) == 0)


def _fape_inputs(seed, B=2, F=9, A=30):
    rng = np.random.default_rng(seed)
    pf, tf = _rigid_np(rng, (B, F)), _rigid_np(rng, (B, F))
    pp = (rng.normal(size=(B, A, 3)) * 5).astype(np.float32)
    tp = (pp + rng.normal(size=(B, A, 3)) * 3).astype(np.float32)
    fm = (rng.uniform(size=(B, F)) > 0.2).astype(np.float32)
    pm = (rng.uniform(size=(B, A)) > 0.2).astype(np.float32)
    return pf, tf, fm, pp, tp, pm


@pytest.mark.parametrize("clamp,eps", [(10.0, 1e-8), (None, 1e-8), (3.0, 1e-4)])
def test_compute_fape_matches_jax(clamp, eps):
    pf, tf, fm, pp, tp, pm = _fape_inputs(6)
    (pf_t, pf_j), (tf_t, tf_j) = _pair(*pf), _pair(*tf)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    got = tg.compute_fape(pf_t, tf_t, t(fm), t(pp), t(tp), t(pm), length_scale=10.0,
                          l1_clamp_distance=clamp, eps=eps)
    want = jg.compute_fape(pf_j, tf_j, jnp.asarray(fm), jnp.asarray(pp), jnp.asarray(tp),
                           jnp.asarray(pm), length_scale=10.0, l1_clamp_distance=clamp, eps=eps)
    assert got.shape == (2,)
    _close(got, want)


def _structure(seed, B=2, F=9, A=30):
    g = torch.Generator().manual_seed(seed)
    frames = tg.RigidArray(tg.random_quat(g, (B, F)), torch.randn((B, F, 3), generator=g) * 5)
    return frames, torch.randn((B, A, 3), generator=g) * 5


def test_fape_zero_for_identical():
    frames, points = _structure(0)
    fape = tg.compute_fape(frames, frames, torch.ones(frames.shape), points, points,
                           torch.ones(points.shape[:-1]))
    np.testing.assert_allclose(fape.numpy(), 0.0, atol=1e-3)


def test_fape_invariant_to_global_motion():
    frames, points = _structure(1)
    g = torch.Generator().manual_seed(2)
    motion = tg.RigidArray(tg.random_quat(g, (1, 1)), torch.randn((1, 1, 3), generator=g) * 10)
    fape = tg.compute_fape(motion.compose(frames), frames, torch.ones(frames.shape),
                           motion.apply(points), points, torch.ones(points.shape[:-1]))
    np.testing.assert_allclose(fape.numpy(), 0.0, atol=1e-3)


def test_fape_clamp():
    frames, points = _structure(3)
    fape = tg.compute_fape(frames, frames, torch.ones(frames.shape), points, points + 1e4,
                           torch.ones(points.shape[:-1]), length_scale=10.0,
                           l1_clamp_distance=10.0)
    np.testing.assert_allclose(fape.numpy(), 1.0, atol=1e-4)
