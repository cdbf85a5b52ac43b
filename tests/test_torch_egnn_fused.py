"""The fused layer (``pmhc_tpu_torch/ops/egnn_fused.py``): its plain
version against the JAX package's lane kernel (interpret mode) and dense
layer, its bf16 mode against the g8 kernel's bf16 mode, the weight
packing against ``pack_lane_weights`` and the wrapper's checks. The CUDA
kernel against the plain version is in ``test_torch_gpu.py``, which runs
on the card without JAX.

Tolerances: fp32 as the JAX lane-kernel tests (quats 5e-5; translations,
torsions, features 2e-4); bf16 as ``test_lane_kernel_bf16_close_to_f32``
(quats 5e-2, translations 0.5, torsions 0.1, features 0.5: the two bf16
modes round at different points and the softmax amplifies logit rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.models.egnn import egnn_forward as j_egnn_forward
from pmhc_tpu.ops.egnn_pallas_lane import egnn_forward_pallas_lane, pack_lane_weights
from pmhc_tpu.ops.egnn_pallas_lane_g8 import egnn_forward_pallas_lane_g8
from pmhc_tpu_torch.geometry import RigidArray as TRigid
from pmhc_tpu_torch.ops import egnn_fused as ef
from tests.test_torch_egnn import assert_layer_close, layer_args, numpy_batch, params_pair

torch.set_num_threads(1)


def _fused(model_layer, t_args, bf16=False):
    """The fused layer on ``egnn_forward``'s arguments, in its output form."""
    q, t, tors, feat = ef.egnn_fused(*ef.layer_inputs(model_layer, *t_args), bf16=bf16)
    return TRigid(q, t), tors, feat


@pytest.mark.parametrize("batch_size", [4, 9])
def test_plain_matches_lane_kernel(batch_size):
    params, model = params_pair()
    j_args, t_args = layer_args(numpy_batch(batch_size), params["gnn1"], model.gnn1)
    j_out = egnn_forward_pallas_lane(params["gnn1"], *j_args, lane_block=128, interpret=True)
    assert_layer_close(_fused(model.gnn1, t_args), j_out)


@pytest.mark.parametrize("layer", ["gnn1", "gnn2"])
def test_plain_matches_dense_layer_both_shapes(layer):
    params, model = params_pair(seed=1)
    j_args, t_args = layer_args(numpy_batch(5, seed=2), params[layer], getattr(model, layer),
                                inner=layer == "gnn2")
    assert_layer_close(_fused(getattr(model, layer), t_args), j_egnn_forward(params[layer], *j_args))


def test_fully_masked_row():
    """An entry with an empty peptide and pocket mask: uniform softmax over
    all NP neighbours (-1e9 penalty, max starts at -1e30) and the identity
    rotation (CNT == 0), as in the dense layer."""
    params, model = params_pair()
    nb = numpy_batch(4)
    nb["mask"][1] = False
    nb["pocket_mask"][1] = False
    j_args, t_args = layer_args(nb, params["gnn1"], model.gnn1)
    out = _fused(model.gnn1, t_args)
    assert_layer_close(out, j_egnn_forward(params["gnn1"], *j_args))
    # identity gd: the row's quat is its input quat, renormalized
    q_in = t_args[0].quats[1]
    np.testing.assert_allclose(out[0].quats[1].numpy(),
                               (q_in / q_in.norm(dim=-1, keepdim=True)).numpy(), atol=1e-6)


def test_zero_quat_neighbours_stay_finite():
    """Padded frames may carry all-zero quats: the max(|q_j|^2, 1e-30)
    guard keeps the layer finite where a plain inverse gives 0/0."""
    params, model = params_pair()
    _, t_args = layer_args(numpy_batch(3), params["gnn1"], model.gnn1)
    t_args[6].quats[:, 60:] = 0.0  # pocket slots past pocket_len (masked)
    q, t, tors, feat = ef.egnn_fused(*ef.layer_inputs(model.gnn1, *t_args))
    for x in (q, t, tors, feat):
        assert torch.isfinite(x).all()


def test_bf16_mode_matches_g8_bf16():
    params, model = params_pair()
    j_args, t_args = layer_args(numpy_batch(4), params["gnn1"], model.gnn1)
    jf, jt, jh = egnn_forward_pallas_lane_g8(params["gnn1"], *j_args, lane_block=128,
                                             interpret=True, bf16=True)
    tf, tt, th = _fused(model.gnn1, t_args, bf16=True)
    np.testing.assert_allclose(tf.quats.numpy(), np.asarray(jf.quats), atol=5e-2)
    np.testing.assert_allclose(np.linalg.norm(tf.quats.numpy(), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tf.trans.numpy(), np.asarray(jf.trans), atol=0.5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=0.1)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=0.5)


def test_layer_context_bf16_projection_and_step_checks():
    """In bf16 mode the context's neighbour projections take one bf16 pass
    (operands rounded, fp32 sums), as ``sample_lane``'s DEFAULT-precision
    XLA matmuls do on the TPU (on the CPU JAX runs them in fp32, so the
    sampler tests cannot show it). A call runs the same layer as
    ``egnn_fused`` on ``layer_inputs`` and checks the per-step tensors."""
    params, model = params_pair()
    _, t_args = layer_args(numpy_batch(3), params["gnn2"], model.gnn2, inner=True)
    frames, tors, h, edge_pre, mask, ph, pf, pm = t_args
    r = lambda x: x.to(torch.bfloat16).to(torch.float32)
    wj = model.gnn2.message_mlp[0].weight.detach()[:, 64:128]
    ctx32 = ef.layer_context(model.gnn2, edge_pre, mask, ph, pf, pm)
    ctx16 = ef.layer_context(model.gnn2, edge_pre, mask, ph, pf, pm, bf16=True)
    np.testing.assert_allclose(ctx16.project(h).numpy(), (r(h) @ r(wj).T).numpy(), atol=1e-6)
    np.testing.assert_allclose(ctx16.aj_pocket.numpy(), (r(ph) @ r(wj).T).numpy(), atol=1e-6)
    np.testing.assert_allclose(ctx32.project(h).numpy(), (h @ wj.T).numpy(), atol=1e-6)
    assert float((ctx16.project(h) - ctx32.project(h)).abs().max()) > 1e-4

    q, t = frames.quats.contiguous(), frames.trans.contiguous()
    got = ctx32(h, q, t, tors, ctx32.project(h))
    want = ef.egnn_fused(*ef.layer_inputs(model.gnn2, *t_args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        ctx32(h[:, :, :-1].contiguous(), q, t, tors, ctx32.project(h))
    with pytest.raises(TypeError):
        ctx32(h, q.double(), t, tors, ctx32.project(h))


@pytest.mark.parametrize("layer,H", [("gnn1", 23), ("gnn2", 64)])
def test_pack_layer_weights_matches_pack_lane_weights(layer, H):
    params, model = params_pair(seed=3)
    lw = [np.asarray(x) for x in pack_lane_weights(params[layer], H, 96)]
    pw = {k: v.numpy() for k, v in ef.pack_layer_weights(getattr(model, layer), H, 96).views.items()}
    T = 64
    w2all, b2all = lw[6], lw[7].ravel()
    expect = {
        "wmi": lw[0], "bm1": lw[1].ravel(), "whm": lw[2], "wad": lw[3].ravel(),
        "waq": lw[4].ravel(), "ba1": lw[5].ravel(), "wfh": lw[8], "wfm2": lw[9],
        "bf1": lw[10].ravel(), "wf2": lw[11], "bf2": lw[12].ravel(), "bl1": lw[13].ravel(),
        "wrq": lw[14], "br1": lw[15].ravel(), "wtt": lw[16], "bt1": lw[17].ravel(),
        # the block-diagonal [32, 4T] head lin2, compacted to its 13 rows
        "w2": np.concatenate((w2all[0:1, 0:T], w2all[8:12, T:2 * T],
                              w2all[16:23, 2 * T:3 * T], w2all[24:25, 3 * T:])),
        "b2": np.concatenate((b2all[0:1], b2all[8:12], b2all[16:23], b2all[24:25])),
    }
    assert set(expect) == set(pw)
    for name, want in expect.items():
        np.testing.assert_allclose(pw[name], want, atol=1e-6, err_msg=name)


def test_wrapper_checks_and_cpu_route():
    params, model = params_pair()
    _, t_args = layer_args(numpy_batch(2), params["gnn1"], model.gnn1)
    args = list(ef.layer_inputs(model.gnn1, *t_args))
    ef.reset_launches()
    ef.egnn_fused(*args)
    ef.egnn_fused(*args, bf16="high")
    assert ef.LAUNCHES == {"fp32": 0, "bf16": 0, "high": 0}  # CPU tensors take the plain version
    bad = list(args)
    bad[5] = bad[5][:, :-1].contiguous()  # a_j with NP-1 neighbours
    with pytest.raises(ValueError):
        ef.egnn_fused(*bad)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        ef.egnn_fused(*bad)
    bad = list(args)
    bad[9] = bad[9].transpose(1, 2).contiguous().transpose(1, 2)  # non-contiguous mask
    with pytest.raises(ValueError):
        ef.egnn_fused(*bad)
