"""pmhc_tpu_torch.geometry against pmhc_tpu.geometry on the same numpy
inputs (atol 1e-6), plus the algebraic properties the JAX package's
geometry tests check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pmhc_tpu.geometry as jg
import pmhc_tpu_torch.geometry as tg

torch.set_num_threads(1)
ATOL = 1e-6


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _sincos(rng, n=64, unit=True):
    # angles kept 0.1 away from 0 and pi: there acos(cos) amplifies a
    # 1-ulp difference of the normalized cosine by 1/|sin a|
    a = rng.uniform(0.1, np.pi - 0.1, size=(n,)) * rng.choice([-1.0, 1.0], size=(n,))
    sc = np.stack((np.sin(a), np.cos(a)), -1).astype(np.float32)
    if not unit:
        sc *= rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    return sc


def _both(fn_t, fn_j, *args):
    out_t = fn_t(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    out_j = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    return out_t.numpy(), np.asarray(out_j)


@pytest.mark.parametrize("name", ["quat_multiply", "quat_invert", "quat_conjugate",
                                  "quat_to_rot", "torch_normalize"])
def test_quat_functions_match_jax(name):
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(64, 4)).astype(np.float32)  # non-unit on purpose
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    args = (q1, q2) if name == "quat_multiply" else (q1,)
    t, j = _both(getattr(tg, name), getattr(jg, name), *args)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=1e-6)


def test_torch_normalize_zero_vector():
    z = np.zeros((3, 4), np.float32)
    t, j = _both(tg.torch_normalize, jg.torch_normalize, z)
    assert np.all(t == 0.0)
    np.testing.assert_array_equal(t, j)


def test_shoemake_matches_jax_and_is_unit():
    x = np.random.default_rng(1).uniform(size=(256, 3)).astype(np.float32)
    t, j = _both(tg.shoemake_quat, jg.shoemake_quat, x)
    np.testing.assert_allclose(t, j, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("amount", [0.0, 0.3, 0.8, 1.0])
def test_partial_rot_matches_jax(amount):
    q = _quats(np.random.default_rng(2))
    q[0] = [1.0, 0.0, 0.0, 0.0]  # identity: zero axis, torch-normalize semantics
    t, j = _both(lambda x: tg.partial_rot(x, amount), lambda x: jg.partial_rot(x, amount), q)
    np.testing.assert_allclose(t, j, atol=ATOL)
    assert np.isfinite(t).all()


@pytest.mark.parametrize("name", ["multiply_sin_cos", "inverse_sin_cos"])
def test_sincos_functions_match_jax(name):
    rng = np.random.default_rng(3)
    a, b = _sincos(rng, unit=False), _sincos(rng, unit=False)
    args = (a, b) if name == "multiply_sin_cos" else (a,)
    t, j = _both(getattr(tg, name), getattr(jg, name), *args)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("amount", [0.25, 0.8])
def test_partial_sin_cos_matches_jax(amount):
    sc = _sincos(np.random.default_rng(4), unit=False)
    t, j = _both(lambda x: tg.partial_sin_cos(x, amount),
                 lambda x: jg.partial_sin_cos(x, amount), sc)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_sin_cos_multiplication_adds_angles():
    rng = np.random.default_rng(5)
    a1, a2 = rng.uniform(-1.5, 1.5, size=(2, 32))
    sc = lambda a: torch.from_numpy(np.stack((np.sin(a), np.cos(a)), -1))
    out = tg.multiply_sin_cos(sc(a1), sc(a2)).numpy()
    np.testing.assert_allclose(out, sc(a1 + a2).numpy(), atol=1e-12)


def test_quat_multiply_matches_matrix_composition():
    rng = np.random.default_rng(6)
    q1, q2 = torch.from_numpy(_quats(rng)), torch.from_numpy(_quats(rng))
    lhs = tg.quat_to_rot(tg.quat_multiply(q1, q2))
    rhs = tg.quat_to_rot(q1) @ tg.quat_to_rot(q2)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


def test_quat_identity_and_inverse():
    q = torch.from_numpy(_quats(np.random.default_rng(7)))
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(tg.quat_multiply(q, tg.quat_invert(q)).numpy(),
                               np.broadcast_to(ident.numpy(), q.shape), atol=1e-6)
    np.testing.assert_allclose(tg.quat_multiply(ident, q).numpy(), q.numpy(), atol=0)


def test_partial_rot_fractional_composition():
    """partial(q, a) (x) partial(q, b) == partial(q, a + b) for unit q."""
    q = torch.from_numpy(_quats(np.random.default_rng(8)))
    lhs = tg.quat_multiply(tg.partial_rot(q, 0.3), tg.partial_rot(q, 0.5))
    np.testing.assert_allclose(lhs.numpy(), tg.partial_rot(q, 0.8).numpy(), atol=1e-5)


def test_partial_sin_cos_fraction_scales_angle():
    a = np.random.default_rng(9).uniform(-3.0, 3.0, size=(32,))
    sc = torch.from_numpy(np.stack((np.sin(a), np.cos(a)), -1))
    out = tg.partial_sin_cos(sc, 0.5).numpy()
    np.testing.assert_allclose(out, np.stack((np.sin(a / 2), np.cos(a / 2)), -1), atol=1e-9)


def test_rigid_from_tensor_7_does_not_normalize():
    t7 = np.random.default_rng(10).normal(size=(5, 7)).astype(np.float32)
    r_t = tg.RigidArray.from_tensor_7(torch.from_numpy(t7))
    r_j = jg.RigidArray.from_tensor_7(jnp.asarray(t7))
    np.testing.assert_array_equal(r_t.quats.numpy(), np.asarray(r_j.quats))
    np.testing.assert_array_equal(r_t.trans.numpy(), np.asarray(r_j.trans))
    np.testing.assert_array_equal(r_t.to_tensor_7().numpy(), t7)
    np.testing.assert_allclose(r_t.rot_mats().numpy(), np.asarray(r_j.rot_mats()), atol=ATOL)
    assert tuple(r_t.shape) == (5,)
    assert jax.default_backend() == "cpu"
