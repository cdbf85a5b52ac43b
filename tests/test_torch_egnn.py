"""The port's dense EGNN layer and score network against pmhc_tpu's
(backend ``xla``) on the same numpy inputs and weights, and the weight
carry-over through a reference-format ``.pth``.

Tolerances are those of the JAX lane-kernel tests
(``tests/unit/test_pallas_lane.py``): quats 5e-5; translations, torsions
and features 2e-4 (fp32 sums taken in another order).

The helpers here (one numpy batch, one set of weights for both
frameworks) are shared by the other ``test_torch_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.data import synthetic_batch
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.models import ScoreNetworkConfig, init_score_network, score_network_forward
from pmhc_tpu.models.egnn import egnn_forward as j_egnn_forward
from pmhc_tpu.models.import_torch import export_torch_checkpoint
from pmhc_tpu.models.score import relpos_edge_pre as j_edge
from pmhc_tpu_torch.diffusion.sampler import fused_forward
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.models import ScoreNetwork, egnn_forward, relpos_edge_pre
from pmhc_tpu_torch.models import ScoreNetworkConfig as TConfig
from pmhc_tpu_torch.models import score_network_forward as t_score_forward
from pmhc_tpu_torch.models.import_params import (
    load_checkpoint,
    params_from_numpy,
    params_to_numpy,
)

torch.set_num_threads(1)
CONFIG = ScoreNetworkConfig()


# -- shared helpers ---------------------------------------------------------

def params_pair(seed=0):
    """(JAX params pytree, port ScoreNetwork) holding the same weights."""
    params = init_score_network(jax.random.key(seed), CONFIG)
    model = ScoreNetwork()
    model.load_state_dict(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params, model


def numpy_batch(batch_size=4, seed=9):
    return synthetic_batch(batch_size=batch_size, seed=seed, as_jax=False)


def jax_model_batch(nb):
    out = {k: jnp.asarray(nb[k]) for k in
           ("torsions", "features", "mask", "pocket_features", "pocket_mask")}
    out["frames"] = JRigid.from_tensor_7(jnp.asarray(nb["frames"]))
    out["pocket_frames"] = JRigid.from_tensor_7(jnp.asarray(nb["pocket_frames"]))
    return out


def torch_model_batch(nb):
    t = lambda x: torch.from_numpy(np.array(x))
    out = {k: t(nb[k]) for k in
           ("torsions", "features", "mask", "pocket_features", "pocket_mask")}
    out["frames"] = TRigid.from_tensor_7(t(nb["frames"]))
    out["pocket_frames"] = TRigid.from_tensor_7(t(nb["pocket_frames"]))
    return out


def layer_args(nb, params_layer, model_layer, inner=False):
    """``egnn_forward`` arguments for both frameworks: layer 1's inputs
    (H=23, time feature 0.5), or layer 2's (``inner``: H=64 features drawn
    from a seed, pocket features zero-padded to 64)."""
    B, N = nb["mask"].shape
    P = nb["pocket_mask"].shape[-1]
    if inner:
        h = np.maximum(np.random.default_rng(1).normal(size=(B, N, 64)), 0).astype(np.float32)
        ph = np.pad(nb["pocket_features"], ((0, 0), (0, 0), (0, 64 - 22)))
    else:
        h = np.concatenate((nb["features"], np.full((B, N, 1), 0.5, np.float32)), -1)
        ph = np.concatenate((nb["pocket_features"], np.zeros((B, P, 1), np.float32)), -1)
    jb, tb = jax_model_batch(nb), torch_model_batch(nb)
    j = (jb["frames"], jb["torsions"], jnp.asarray(h), j_edge(params_layer, N),
         jb["mask"].astype(jnp.float32), jnp.asarray(ph), jb["pocket_frames"],
         jb["pocket_mask"].astype(jnp.float32))
    with torch.no_grad():
        e = relpos_edge_pre(model_layer, N)
    t = (tb["frames"], tb["torsions"], torch.from_numpy(h), e, tb["mask"].float(),
         torch.from_numpy(np.ascontiguousarray(ph)), tb["pocket_frames"],
         tb["pocket_mask"].float())
    return j, t


def assert_layer_close(t_out, j_out, q_atol=5e-5, atol=2e-4):
    (tf, tt, th), (jf, jt, jh) = t_out, j_out
    np.testing.assert_allclose(tf.quats.numpy(), np.asarray(jf.quats), atol=q_atol)
    np.testing.assert_allclose(tf.trans.numpy(), np.asarray(jf.trans), atol=atol)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=atol)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=atol)


def assert_pred_close(t_pred, j_pred, q_atol=5e-5, atol=2e-4):
    np.testing.assert_allclose(t_pred["frames"].quats.numpy(),
                               np.asarray(j_pred["frames"].quats), atol=q_atol)
    np.testing.assert_allclose(t_pred["frames"].trans.numpy(),
                               np.asarray(j_pred["frames"].trans), atol=atol)
    np.testing.assert_allclose(t_pred["torsions"].numpy(),
                               np.asarray(j_pred["torsions"]), atol=atol)


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["gnn1", "gnn2"])
def test_dense_layer_matches_jax(layer):
    params, model = params_pair()
    nb = numpy_batch()
    j_args, t_args = layer_args(nb, params[layer], getattr(model, layer), inner=layer == "gnn2")
    with torch.no_grad():
        t_out = egnn_forward(getattr(model, layer), *t_args)
    assert_layer_close(t_out, j_egnn_forward(params[layer], *j_args))


@pytest.mark.parametrize("t", [1, 500, 1000])
@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_score_network_matches_jax(t, backend):
    """Both port backends against the JAX package's xla backend: the dense
    ``score_network_forward``, and the sampler's per-step fused forward
    (static context built once, the fused layer's plain version on CPU)."""
    params, model = params_pair()
    nb = numpy_batch(seed=3)
    j_pred = score_network_forward(params, jax_model_batch(nb), jnp.asarray(t, jnp.int32), CONFIG)
    tb = torch_model_batch(nb)
    with torch.no_grad():
        if backend == "dense":
            t_pred = t_score_forward(model, tb, t, TConfig())
        else:
            forward = fused_forward(model, tb, TConfig(backend=backend), bf16=False)
            q, tr, tors = forward(tb["frames"].quats.contiguous(), tb["frames"].trans.contiguous(),
                                  tb["torsions"].contiguous(), t)
            t_pred = {"frames": TRigid(q, tr), "torsions": tors}
    assert_pred_close(t_pred, j_pred)


def test_score_network_per_sample_t():
    params, model = params_pair()
    nb = numpy_batch(batch_size=3, seed=4)
    ts = np.array([1, 400, 1000], np.int32)
    j_pred = score_network_forward(params, jax_model_batch(nb), jnp.asarray(ts), CONFIG)
    with torch.no_grad():
        t_pred = t_score_forward(model, torch_model_batch(nb), torch.from_numpy(ts), TConfig())
    assert_pred_close(t_pred, j_pred)


def test_state_dict_names_and_size():
    model = ScoreNetwork(generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert len(state) == 48
    assert sum(v.numel() for v in state.values()) == 79195
    assert "gnn1.rotation_mlp.2.weight" in state and "gnn2.feature_mlp.0.bias" in state
    bound = 1.0 / np.sqrt(model.gnn1.message_mlp[0].in_features)
    assert float(model.gnn1.message_mlp[0].weight.detach().abs().max()) <= bound


def test_checkpoint_carry_over(tmp_path):
    """A .pth written by the JAX package's exporter loads strictly into the
    port, equals params_from_numpy, gives the same outputs, and
    params_to_numpy inverts params_from_numpy."""
    params, model = params_pair(seed=5)
    path = str(tmp_path / "model.pth")
    export_torch_checkpoint(params, path)
    loaded = load_checkpoint(path)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(), v.numpy())

    nb = numpy_batch(batch_size=2, seed=6)
    with torch.no_grad():
        a = t_score_forward(model, torch_model_batch(nb), 700, TConfig())
        b = t_score_forward(loaded, torch_model_batch(nb), 700, TConfig())
    np.testing.assert_array_equal(a["frames"].trans.numpy(), b["frames"].trans.numpy())

    back = params_to_numpy(model.state_dict())
    for lp, lb in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(lp), lb)
