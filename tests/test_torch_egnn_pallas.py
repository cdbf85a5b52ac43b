"""The port's ``pallas`` backend (``pmhc_tpu_torch/ops/egnn_pallas.py``)
against the JAX package on the same numpy inputs and weights. On the CPU
the wrapper takes its plain version; the CUDA kernel against that plain
version is in ``test_torch_kernel_emulation.py`` (g++), ``test_torch_gpu.py``
and ``chip_smoke.py`` (the card).

Tolerances:
- against ``pmhc_tpu.ops.egnn_forward_pallas(interpret=True)`` and the
  dense JAX layer: those of ``tests/unit/test_pallas.py``, quats 2e-5, the
  rest 1e-4 (fp32 sums taken in another order);
- gradients against ``jax.grad`` of the dense JAX layer: ``atol=2e-3,
  rtol=1e-3``, as ``test_pallas_trainable_grads_match_xla``;
- the score network and the 4-step trajectory against JAX's ``xla``
  backend: those of ``test_torch_egnn.py`` and ``test_torch_sampler.py``;
- the ``Trainer`` against the port's dense backend: the two differ only in
  the forward's fp32 sum order (the backward is the same dense autograd),
  so losses agree to rtol 1e-5; parameters after 3 Adam steps to 3 x lr,
  as ``test_torch_train.py``: Adam moves a parameter by up to ~lr per step
  whatever its gradient's size, so where a gradient is cancellation noise
  (the attention biases) an ulp of difference becomes O(lr).

Batches hold short peptides (lengths 9, 5, 1, 9, 9), so the padded
peptide rows are fully masked: their softmax weights are the near-uniform
ones of the fp32 ``- 1e9`` penalty, and every row is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion import sample as j_sample
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models import score_network_forward as j_score_forward
from pmhc_tpu.models.egnn import egnn_forward as j_egnn_forward
from pmhc_tpu.ops import egnn_forward_pallas as j_egnn_forward_pallas
from pmhc_tpu_torch.data.synthetic import synthetic_batch
from pmhc_tpu_torch.diffusion import DiffusionConfig, sample
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.models import ScoreNetworkConfig
from pmhc_tpu_torch.models import score_network_forward as t_score_forward
from pmhc_tpu_torch.models.import_params import params_to_numpy
from pmhc_tpu_torch.models.score import resolve_backend
from pmhc_tpu_torch.ops import egnn_pallas as ep
from pmhc_tpu_torch.train import TrainConfig, Trainer
from tests.test_torch_egnn import (
    assert_pred_close,
    jax_model_batch,
    layer_args,
    numpy_batch,
    params_pair,
    torch_model_batch,
)
from tests.test_torch_sampler import T_STEPS, _assert_traj_close, _inputs

torch.set_num_threads(1)
PEPTIDE_LENGTHS = (9, 5, 1, 9, 9)


def short_batch(batch_size, seed):
    """A numpy batch whose peptides have ``PEPTIDE_LENGTHS`` residues."""
    nb = numpy_batch(batch_size, seed=seed)
    for b in range(batch_size):
        n = PEPTIDE_LENGTHS[b % len(PEPTIDE_LENGTHS)]
        nb["mask"][b, n:] = False
        nb["features"][b, n:] = 0.0
    return nb


def _assert_layer(t_out, j_out, q_atol=2e-5, atol=1e-4):
    (tf, tt, th), (jf, jt, jh) = t_out, j_out
    np.testing.assert_allclose(tf.quats.numpy(), np.asarray(jf.quats), atol=q_atol, err_msg="quats")
    np.testing.assert_allclose(tf.trans.numpy(), np.asarray(jf.trans), atol=atol, err_msg="trans")
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=atol, err_msg="torsions")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=atol, err_msg="features")


def test_plain_matches_jax_pallas_kernel_interpret():
    """Layer 1 at batch 5, ``batch_block=2``: exercises the JAX padder."""
    params, model = params_pair(seed=1)
    nb = short_batch(5, seed=3)
    j_args, t_args = layer_args(nb, params["gnn1"], model.gnn1)
    with torch.no_grad():
        t_out = ep.egnn_forward_pallas(model.gnn1, *t_args)
    _assert_layer(t_out, j_egnn_forward_pallas(params["gnn1"], *j_args, batch_block=2,
                                               interpret=True))


@pytest.mark.parametrize("layer", ["gnn1", "gnn2"])
def test_plain_matches_dense_jax_layer(layer):
    params, model = params_pair(seed=2)
    nb = short_batch(5, seed=4)
    assert (nb["mask"].sum(-1) < 16).all()  # every entry has fully masked rows
    j_args, t_args = layer_args(nb, params[layer], getattr(model, layer), inner=layer == "gnn2")
    with torch.no_grad():
        t_out = ep.egnn_forward_pallas(getattr(model, layer), *t_args)
    _assert_layer(t_out, j_egnn_forward(params[layer], *j_args))


def test_packed_weights_are_the_jax_kernel_arrays_in_order():
    params, model = params_pair(seed=3)
    w = ep.pack_pallas_weights(model.gnn1)
    want = np.concatenate([np.asarray(params["gnn1"][name][lin][k], np.float32).ravel()
                           for name in ep.MLPS for lin in ("lin1", "lin2") for k in ("w", "b")])
    np.testing.assert_array_equal(w.buf.numpy(), want)
    assert (w.H, w.E, w.O) == (23, 31, 64)
    assert w["torsion.w1"].shape == (64 + 14, 64)


def _loss_t(out):
    (f, tors, feat) = out
    return (torch.sum(f.trans ** 2) + torch.sum(f.quats ** 2) + torch.sum(tors ** 2)
            + torch.sum(feat ** 2))


def test_trainable_grads_match_jax_grad_of_dense_layer():
    """Every parameter's gradient and those of the frames, torsions and
    features, through the kernel forward and the rematerialising backward."""
    params, model = params_pair(seed=4)
    nb = short_batch(2, seed=5)
    j_args, t_args = layer_args(nb, params["gnn1"], model.gnn1)

    def loss_j(p, frames, tors, feats):
        f, t, h = j_egnn_forward(p, frames, tors, feats, *j_args[3:])
        return jnp.sum(f.trans ** 2) + jnp.sum(f.quats ** 2) + jnp.sum(t ** 2) + jnp.sum(h ** 2)

    jg = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(params["gnn1"], *j_args[:3])
    frames, tors, feats = t_args[:3]
    q = frames.quats.clone().requires_grad_(True)
    tr = frames.trans.clone().requires_grad_(True)
    tors = tors.clone().requires_grad_(True)
    feats = feats.clone().requires_grad_(True)
    layer = model.gnn1
    out = ep.egnn_forward_pallas_trainable(layer, TRigid(q, tr), tors, feats, *t_args[3:])
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(_loss_t(out), [q, tr, tors, feats] + list(layer.parameters()))
    tol = dict(atol=2e-3, rtol=1e-3)
    got = params_to_numpy({f"gnn1.{n}": g for n, g in zip(names, grads[4:])})["gnn1"]
    for mlp, lins in jg[0].items():
        for lin, leaves in lins.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(got[mlp][lin][k], np.asarray(v), err_msg=f"{mlp} {lin} {k}",
                                           **tol)
    for name, g, want in (("quats", grads[0], jg[1].quats), ("trans", grads[1], jg[1].trans),
                          ("torsions", grads[2], jg[2]), ("features", grads[3], jg[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("t", [1, 700])
def test_score_network_pallas_matches_jax_xla(t):
    params, model = params_pair()
    nb = short_batch(4, seed=6)
    j_pred = j_score_forward(params, jax_model_batch(nb), jnp.asarray(t, jnp.int32), JConfig())
    with torch.no_grad():
        t_pred = t_score_forward(model, torch_model_batch(nb), t, ScoreNetworkConfig(backend="pallas"))
    assert_pred_close(t_pred, j_pred)


def test_pallas_sampler_matches_jax_generic_sample():
    """4 steps with the same injected noise against ``sample`` of the JAX
    package with its ``xla`` backend (what the ``pallas`` backend computes)."""
    params, model = params_pair(seed=2)
    nb, j_inj, t_inj = _inputs(T_STEPS)
    nb["mask"][1, 4:] = False
    j_out = j_sample(params, jax_model_batch(nb), jax.random.key(0),
                     JDiffusionConfig(noise_step_count=T_STEPS),
                     JConfig(noise_step_count=T_STEPS, backend="xla"), injected_noise=j_inj)
    ep.reset_launches()
    t_out = sample(model, torch_model_batch(nb), DiffusionConfig(noise_step_count=T_STEPS),
                   ScoreNetworkConfig(noise_step_count=T_STEPS, backend="pallas"),
                   injected_noise=t_inj)
    assert ep.LAUNCHES["fp32"] == 0  # CPU tensors take the plain version
    _assert_traj_close(t_out, j_out)


def test_trainer_pallas_tracks_dense():
    """3 ``Trainer`` steps, same seed (same weights, timesteps and noise),
    ``pallas`` against ``dense``."""
    trainers = {bk: Trainer(ScoreNetworkConfig(backend=bk), train_config=TrainConfig(seed=3),
                            device="cpu") for bk in ("pallas", "dense")}
    for k in range(3):
        batch = synthetic_batch(batch_size=4, peptide_len=6 + k, seed=40 + k)
        sums = {bk: tr.train_batch(batch) for bk, tr in trainers.items()}
        for name, v in sums["dense"].items():
            np.testing.assert_allclose(float(sums["pallas"][name]), float(v), rtol=1e-5,
                                       err_msg=f"step {k} {name}")
    for (name, p), q in zip(trainers["pallas"].model.named_parameters(),
                            trainers["dense"].model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=3e-3, err_msg=name)


@pytest.mark.parametrize("name,resolved", [
    ("dense", "dense"), ("xla", "dense"), ("fused", "fused"), ("auto", "fused"),
    ("pallas_lane", "fused"), ("g8", "fused"), ("pallas", "pallas"),
    ("blockwise", "blockwise"), ("cp", NotImplementedError), ("ring", NotImplementedError),
    ("mosaic", ValueError)])
def test_resolve_backend_names(name, resolved):
    if isinstance(resolved, str):
        assert resolve_backend(name) == resolved
    else:
        with pytest.raises(resolved, match="ROADMAP" if resolved is NotImplementedError else name):
            resolve_backend(name)


def test_wrapper_checks_its_inputs():
    _, model = params_pair(seed=5)
    tb = torch_model_batch(short_batch(2, seed=7))
    ctx = ep.pallas_context(model.gnn1, torch.zeros(16, 16, 64), tb["mask"].float(),
                            torch.zeros(2, 80, 23), tb["pocket_frames"], tb["pocket_mask"].float())
    h = torch.zeros(2, 16, 23)
    q, t, tors = (tb["frames"].quats.contiguous(), tb["frames"].trans.contiguous(),
                  tb["torsions"].contiguous())
    out = ctx(h, q, t, tors)
    assert [tuple(x.shape) for x in out] == [(2, 16, 4), (2, 16, 3), (2, 16, 7, 2), (2, 16, 64)]
    with pytest.raises(TypeError, match="float32"):
        ctx(h.double(), q, t, tors)
    with pytest.raises(ValueError, match="shape"):
        ctx(torch.zeros(2, 16, 64), q, t, tors)
    with pytest.raises(ValueError, match="contiguous"):
        ctx(torch.zeros(2, 23, 16).transpose(1, 2), q, t, tors)
    with pytest.raises(ValueError, match="width"):
        ep.pallas_context(model.gnn1, torch.zeros(16, 16, 64), tb["mask"].float(),
                          torch.zeros(2, 80, 64), tb["pocket_frames"], tb["pocket_mask"].float())
