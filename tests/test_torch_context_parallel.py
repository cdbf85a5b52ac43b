"""The port's context parallelism (``pmhc_tpu_torch/parallel/context.py``)
on the CPU, against the JAX package.

The port's layer runs in gloo groups of spawned processes (rank bodies in
``tests/_torch_mesh_ranks.py``, each spawn with a deadline); the JAX side
here, ``egnn_layer_cp`` inside ``shard_map`` on conftest's virtual
devices. Inputs come from seeds (numpy). Held: ``egnn_layer_cp`` (both
``ring`` values) on data 2 x context 2 and on context 4 against JAX's
``egnn_layer_cp`` and against the port's dense layer (values to 1e-5 of
each output's largest magnitude), and its weight gradients, summed over
``data`` and averaged over ``context`` as the trainer reduces them,
against ``jax.grad`` of the dense layer (to 1e-5 of each gradient's
largest magnitude; the attention output bias, whose gradient is zero but
for rounding, to 1e-5 of the layer's largest); the divisibility errors (JAX's messages);
``sample_sharded`` (``cp`` on data 2 x context 2, ``ring`` on context 4)
against the JAX package's ``sample`` with the same injected noise over 4
steps (the sampler tests' tolerances); and DP x TP x CP (model 2 x context
2) ``Trainer`` steps against the single-process dense ``Trainer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pmhc_tpu.diffusion import DiffusionConfig as JDiffusionConfig
from pmhc_tpu.diffusion import sample as j_sample
from pmhc_tpu.geometry import RigidArray as JRigid
from pmhc_tpu.models import ScoreNetworkConfig as JConfig
from pmhc_tpu.models.egnn import egnn_forward as j_egnn_forward
from pmhc_tpu.models.score import relpos_edge_pre as j_edge
from pmhc_tpu.parallel.context import egnn_layer_cp as j_egnn_layer_cp
from pmhc_tpu_torch.geometry import RigidArray
from pmhc_tpu_torch.models import egnn_forward, relpos_edge_pre
from pmhc_tpu_torch.models.import_params import params_from_numpy
from pmhc_tpu_torch.parallel.distributed import spawn
from tests import _torch_mesh_ranks as ranks
from tests.test_torch_egnn import jax_model_batch, numpy_batch, params_pair
from tests.test_torch_parallel import (
    CHANGE_TOL,
    DEADLINE_S,
    LOSS_RTOL,
    change_errors,
    single_trainer,
    state_np,
)
from tests.test_torch_sampler import _assert_traj_close, _inputs

torch.set_num_threads(1)
# a share of each output's / gradient's largest magnitude
LAYER_TOL = 1e-5
MESHES = {"data2_context2": (2, 1, 2), "context4": (1, 1, 4)}


def layer_inputs(B=4, seed=9):
    """Layer 1's inputs (time feature 0.5) as numpy: q, t, torsions, h,
    mask, pocket h, pocket q, pocket t, pocket mask."""
    nb = numpy_batch(B, seed)
    jb = jax_model_batch(nb)
    N, Pk = nb["mask"].shape[1], nb["pocket_mask"].shape[1]
    h = np.concatenate((nb["features"], np.full((B, N, 1), 0.5, np.float32)), -1)
    ph = np.concatenate((nb["pocket_features"], np.zeros((B, Pk, 1), np.float32)), -1)
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f(jb["frames"].quats), f(jb["frames"].trans), f(nb["torsions"]), h,
            f(nb["mask"]), ph, f(jb["pocket_frames"].quats), f(jb["pocket_frames"].trans),
            f(nb["pocket_mask"]))


def j_layer_args(params_l, args):
    q, t, tors, h, mask, ph, pq, pt, pmask = (jnp.asarray(x) for x in args)
    return (JRigid(q, t), tors, h, j_edge(params_l, mask.shape[1]), mask, ph, JRigid(pq, pt), pmask)


def j_layer_cp(params_l, args, shape, ring):
    """JAX's ``egnn_layer_cp`` in ``shard_map`` over a (data, context) mesh."""
    d, c = shape[0], shape[2]
    mesh = Mesh(np.asarray(jax.devices()[:d * c]).reshape(d, c), ("data", "context"))
    fn = shard_map(
        lambda p, fr, tors, h, e, m, ph, pf, pm: j_egnn_layer_cp(
            p, fr, tors, h, e, m, ph, pf, pm, axis_name="context", ring=ring),
        mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P(), P("data"), P("data"), P("data"),
                  P("data")),
        out_specs=(P("data"), P("data"), P("data")))
    f, tors, h = jax.jit(fn)(params_l, *j_layer_args(params_l, args))
    return [np.asarray(x) for x in (f.quats, f.trans, tors, h)]


def assert_close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LAYER_TOL * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def layer_case():
    params, model = params_pair(seed=3)
    args = layer_inputs()
    rng = np.random.default_rng(17)
    cot = [rng.normal(size=s).astype(np.float32) for s in
           (args[0].shape, args[1].shape, args[2].shape, (args[0].shape[0], args[0].shape[1], 64))]
    return params, model, args, cot


@pytest.fixture(scope="module", params=list(MESHES))
def cp_runs(request, layer_case):
    _, model, args, cot = layer_case
    shape = MESHES[request.param]
    res = spawn(ranks.cp_layer, int(np.prod(shape)), args=(shape, state_np(model), args, cot),
                device="cpu", timeout=DEADLINE_S)
    return shape, res


def _assemble(res, ring, i, B):
    """Output ``i`` of the global batch from the ranks' rows (context ranks agree)."""
    out = [None] * B
    for r in res:
        lo, hi = r["rows"]
        rows = r[ring]["outs"][i]
        for k in range(lo, hi):
            if out[k] is not None:
                np.testing.assert_array_equal(out[k], rows[k - lo])
            out[k] = rows[k - lo]
    return np.stack(out)


@pytest.mark.parametrize("ring", [False, True])
def test_cp_layer_matches_jax_and_dense(cp_runs, layer_case, ring):
    params, model, args, _ = layer_case
    shape, res = cp_runs
    want_jax = j_layer_cp(params["gnn1"], args, shape, ring)
    layer = model.gnn1
    q, t, tors, h, mask, ph, pq, pt, pmask = (torch.from_numpy(x) for x in args)
    with torch.no_grad():
        f, d_tors, d_h = egnn_forward(layer, RigidArray(q, t), tors, h,
                                      relpos_edge_pre(layer, mask.shape[1]), mask, ph,
                                      RigidArray(pq, pt), pmask)
    want_dense = [x.numpy() for x in (f.quats, f.trans, d_tors, d_h)]
    for i, name in enumerate(("quats", "trans", "torsions", "features")):
        got = _assemble(res, ring, i, len(args[4]))
        assert_close(got, want_jax[i], err_msg=f"{name} vs JAX egnn_layer_cp")
        assert_close(got, want_dense[i], err_msg=f"{name} vs the port's dense layer")


@pytest.mark.parametrize("ring", [False, True])
def test_cp_layer_gradients_match_jax_grad(cp_runs, layer_case, ring):
    """The ranks' weight gradients, summed over data and averaged over
    context (the trainer's reduction), against ``jax.grad`` of the dense
    layer on the global batch."""
    params, _, args, cot = layer_case
    shape, res = cp_runs

    def loss(p):
        f, tors, h = j_egnn_forward(p, *j_layer_args(p, args))
        return sum(jnp.sum(o * c) for o, c in zip((f.quats, f.trans, tors, h), cot))

    want = params_from_numpy({"gnn1": jax.tree_util.tree_map(np.asarray,
                                                             jax.grad(loss)(params["gnn1"]))})
    n_context = shape[2]
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        got = sum(r[ring]["grads"][name.split(".", 1)[1]] for r in res) / n_context
        if name.endswith("attention_mlp.2.bias"):
            # zero but for rounding (the softmax ignores a shift of its logits):
            # held to 1e-5 of the layer's largest gradient
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=LAYER_TOL * scale, err_msg=name)
        else:
            assert_close(got, w.numpy(), err_msg=name)


def test_cp_divisibility_errors_are_jax_messages():
    params, model = params_pair(seed=4)
    cases = [(16, 81, False), (15, 81, True), (16, 80, True)]
    got = spawn(ranks.cp_divisibility, 2, args=(state_np(model), cases), device="cpu",
                timeout=DEADLINE_S)[0]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("context",))
    for (n, pk, ring), msg in zip(cases, got):
        z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
        fn = shard_map(lambda p: j_egnn_layer_cp(
            p, JRigid(z(1, n, 4), z(1, n, 3)), z(1, n, 7, 2), z(1, n, 23),
            j_edge(p, n), jnp.ones((1, n)), z(1, pk, 23), JRigid(z(1, pk, 4), z(1, pk, 3)),
            jnp.ones((1, pk)), axis_name="context", ring=ring),
            mesh=mesh, in_specs=(P(),), out_specs=(P(), P(), P()))
        if msg is None:  # N and N + P both divide
            assert (n + pk) % 2 == 0 and n % 2 == 0
            continue
        with pytest.raises(ValueError) as e:
            jax.jit(fn)(params["gnn1"])
        assert msg == str(e.value)


@pytest.mark.parametrize("backend,shape", [("cp", (2, 1, 2)), ("ring", (1, 1, 4))])
def test_sample_sharded_matches_jax_sample(backend, shape):
    T = 4
    params, model = params_pair(seed=2)
    nb, j_inj, t_inj = _inputs(T, B=4)
    init = (nb["frames"][..., :4], nb["frames"][..., 4:], nb["torsions"])
    noise = tuple(x.numpy() for x in (t_inj["frames"].quats, t_inj["frames"].trans,
                                      t_inj["torsions"]))
    j_out = j_sample(params, jax_model_batch(nb), jax.random.key(0),
                     JDiffusionConfig(noise_step_count=T), JConfig(noise_step_count=T),
                     injected_noise=j_inj)
    res = spawn(ranks.sharded_sample, int(np.prod(shape)),
                args=(shape, backend, state_np(model), nb, init, noise, T), device="cpu",
                timeout=DEADLINE_S)
    for q, t, tors in res:
        _assert_traj_close({"frames": RigidArray(torch.from_numpy(q), torch.from_numpy(t)),
                            "torsions": torch.from_numpy(tors)}, j_out)


def test_dp_tp_cp_trainer_matches_single_process():
    """Model 2 x context 2 on the xla backend (the port: the cp layer with
    Megatron MLPs) against the one-process dense ``Trainer``."""
    from pmhc_tpu_torch.data.synthetic import synthetic_batch

    batches = [synthetic_batch(batch_size=6, seed=60 + k) for k in range(3)]
    res = spawn(ranks.trainer_runs, 4, args=([((1, 2, 2), "xla", True, True, 0.5, False)], batches),
                device="cpu", timeout=DEADLINE_S)
    want_l, want_c = single_trainer("dense", 0.5, False, batches)
    for rank, r in enumerate(res):
        losses, change = r[0]
        np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL, err_msg=f"rank {rank}")
        err = change_errors(change, want_c)
        assert err["rel"] <= CHANGE_TOL["rel"] and err["median_rel"] <= CHANGE_TOL["median_rel"], \
            (rank, err)
