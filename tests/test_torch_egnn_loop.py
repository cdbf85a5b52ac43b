"""The training layer (``pmhc_tpu_torch/ops/egnn_loop.py``) against the
JAX package's differentiable lane layer, on the same numpy inputs and
weights. On the CPU the loop runs its plain version and autograd through
it; the CUDA kernels against that plain version are in
``test_torch_gpu.py`` and ``chip_smoke.py``.

- Values and gradients (every layer parameter and every differentiable
  input) against ``egnn_forward_pallas_lane_vjp(interpret=True, g8=False)``
  and against ``jax.grad`` of the dense ``egnn_forward``: quats 5e-5, the
  other values 2e-4, gradients ``max(2e-4 * |ref|max, 3e-5)`` (the floor:
  ``attention.lin2.b``'s true gradient is analytically zero, so both
  sides give cancellation noise), as ``tests/unit/test_pallas_lane_vjp.py``.
- The plain loop's backward against the JAX loop's custom VJP, cotangent
  by cotangent, with the same tolerance.
- bf16 against ``egnn_forward_pallas_lane_vjp(interpret=True, bf16=True,
  g8=True)`` and against the fp32 gradients. On the CPU JAX runs its
  DEFAULT-precision node projections in fp32, so the test runs the port's
  in fp32 too. The two bf16 loops round at different points (the port
  keeps the attention's rank-1 terms, the biases, the torsion node term
  and the neighbour sums in fp32; see ``csrc/egnn_loop.cu``), so the
  tolerances are measured ones with 2-3x headroom (``BF16_*``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmhc_tpu.models.egnn import egnn_forward as j_egnn_forward
from pmhc_tpu.ops.egnn_pallas_lane import (
    HEAD_OUT,
    lane_j_mat,
    lane_s_mat,
    lane_to_node,
    nbr_to_lane,
    node_to_lane,
)
from pmhc_tpu.ops.egnn_pallas_lane_g8 import nbr_to_cm8
from pmhc_tpu.ops.egnn_pallas_lane_vjp import _cell_geometry, _loop_fn, egnn_forward_pallas_lane_vjp
from pmhc_tpu_torch.models.egnn import message_mask
from pmhc_tpu_torch.ops import egnn_loop as el
from pmhc_tpu_torch.ops.egnn_loop import egnn_forward_loop
from tests.test_torch_egnn import layer_args, numpy_batch, params_pair

torch.set_num_threads(1)

T = 64
# bf16 against g8 bf16, measured here (B=4, layer 1, node projections in
# fp32 on both sides): quats 1.98e-2, translations 1.49e-2, torsions
# 4.3e-4, features 1.1e-4; gradients 3.8e-2 of the largest magnitude
# (edge_pre), 1.6e-3 absolute on the small attention lin1 bias. Both
# against the fp32 gradients: the port 3.8e-2, g8 4.2e-2.
BF16_VAL_TOL = {"q": 5e-2, "t": 5e-2, "tors": 2e-3, "feat": 1e-3}
BF16_GRAD_REL, BF16_GRAD_FLOOR = 1e-1, 4e-3

NAMES = ("quats", "trans", "torsions", "h", "edge_pre", "pocket_h", "pk_quats", "pk_trans")


def _loss_jax(fn, params, j_args):
    """Gradients of a fixed scalar of the layer's outputs with respect to
    the parameters and the eight differentiable inputs."""
    frames, tors, h, edge, mask, ph, pf, pm = j_args
    R = type(frames)

    def f(p, q, t, tr, hh, e, pkh, pq, pt):
        fr, to, out = fn(p, R(q, t), tr, hh, e, mask, pkh, R(pq, pt), pm)
        return (jnp.sum(fr.trans ** 2) + jnp.sum(fr.quats * 0.7) + jnp.sum(to ** 2)
                + jnp.sum(out * 0.3))

    return jax.jit(jax.grad(f, argnums=tuple(range(9))))(
        params, frames.quats, frames.trans, tors, h, edge, ph, pf.quats, pf.trans)


def _loss_torch(layer, t_args, bf16=False):
    frames, tors, h, edge, mask, ph, pf, pm = t_args
    R = type(frames)
    leaves = [x.detach().clone().requires_grad_(True) for x in
              (frames.quats, frames.trans, tors, h, edge, ph, pf.quats, pf.trans)]
    q, t, tr, hh, e, pkh, pq, pt = leaves
    fr, to, out = egnn_forward_loop(layer, R(q, t), tr, hh, e, mask, pkh, R(pq, pt), pm, bf16=bf16)
    loss = (fr.trans ** 2).sum() + (fr.quats * 0.7).sum() + (to ** 2).sum() + (out * 0.3).sum()
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()) + leaves)
    return (fr, to, out), dict(zip(params, grads[:len(params)])), grads[len(params):]


def _jax_param_grad(tree, name):
    """The JAX gradient leaf for a port parameter name (``attention_mlp.0.weight``)."""
    mlp, seq, kind = name.split(".")
    leaf = tree[mlp[:-4]]["lin1" if seq == "0" else "lin2"]["w" if kind == "weight" else "b"]
    return np.asarray(leaf).T if kind == "weight" else np.asarray(leaf)


def _assert_grads_close(t_params, t_inputs, j_grads, rel=2e-4, floor=3e-5):
    for name, g in t_params.items():
        want = _jax_param_grad(j_grads[0], name)
        np.testing.assert_allclose(g.numpy(), want, atol=max(rel * float(np.abs(want).max()), floor),
                                   err_msg=name)
    for name, g, want in zip(NAMES, t_inputs, j_grads[1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, atol=max(rel * float(np.abs(want).max()), floor),
                                   err_msg=name)


def _assert_values_close(t_out, j_out, tol):
    (tf, tt, th), (jf, jt, jh) = t_out, j_out
    for name, a, b in (("q", tf.quats, jf.quats), ("t", tf.trans, jf.trans), ("tors", tt, jt),
                       ("feat", th, jh)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol[name], err_msg=name)


FP32_VAL_TOL = {"q": 5e-5, "t": 2e-4, "tors": 2e-4, "feat": 2e-4}


def test_layer_matches_lane_vjp_interpret():
    params, model = params_pair()
    j_args, t_args = layer_args(numpy_batch(4), params["gnn1"], model.gnn1)
    fn = lambda p, *a: egnn_forward_pallas_lane_vjp(p, *a, interpret=True, g8=False)
    j_out = fn(params["gnn1"], *j_args)
    t_out, t_params, t_inputs = _loss_torch(model.gnn1, t_args)
    _assert_values_close(t_out, j_out, FP32_VAL_TOL)
    _assert_grads_close(t_params, t_inputs, _loss_jax(fn, params["gnn1"], j_args))


@pytest.mark.parametrize("layer", ["gnn1", "gnn2"])
def test_layer_grads_match_dense_jax(layer):
    params, model = params_pair(seed=2)
    j_args, t_args = layer_args(numpy_batch(4, seed=6), params[layer], getattr(model, layer),
                                inner=layer == "gnn2")
    t_out, t_params, t_inputs = _loss_torch(getattr(model, layer), t_args)
    _assert_values_close(t_out, j_egnn_forward(params[layer], *j_args), FP32_VAL_TOL)
    _assert_grads_close(t_params, t_inputs, _loss_jax(j_egnn_forward, params[layer], j_args))


def test_fully_masked_row_matches_dense_jax():
    """An entry with an empty peptide and pocket mask: uniform softmax over
    all NP slots and the identity rotation, in values and gradients."""
    params, model = params_pair(seed=4)
    nb = numpy_batch(3, seed=8)
    nb["mask"][1] = False
    nb["pocket_mask"][1] = False
    j_args, t_args = layer_args(nb, params["gnn1"], model.gnn1)
    t_out, t_params, t_inputs = _loss_torch(model.gnn1, t_args)
    _assert_values_close(t_out, j_egnn_forward(params["gnn1"], *j_args), FP32_VAL_TOL)
    _assert_grads_close(t_params, t_inputs, _loss_jax(j_egnn_forward, params["gnn1"], j_args))


def test_zero_quats_in_masked_slots_stay_finite():
    """Padded pocket slots may carry all-zero quats. The max(|q_j|^2, 1e-30)
    guard (and dividing by |q_j|^2 twice in the backward) keeps values and
    gradients finite, and masked slots change nothing: the layer equals
    itself with identity quats there (the dense layers give NaN). Every
    peptide row is valid here: a fully masked row weighs all NP slots."""
    params, model = params_pair(seed=4)
    nb = numpy_batch(3, seed=8)
    nb["mask"][:] = True
    assert not nb["pocket_mask"][:, 70:].any()
    _, t_ident = layer_args(nb, params["gnn1"], model.gnn1)
    nb["pocket_frames"][:, 70:, :4] = 0.0
    _, t_zero = layer_args(nb, params["gnn1"], model.gnn1)
    out_z, par_z, inp_z = _loss_torch(model.gnn1, t_zero)
    out_i, par_i, inp_i = _loss_torch(model.gnn1, t_ident)
    for g in list(par_z.values()) + list(inp_z):
        assert torch.isfinite(g).all()
    (fz, tz, hz), (fi, ti, hi) = out_z, out_i
    for a, b in ((fz.quats, fi.quats), (fz.trans, fi.trans), (tz, ti), (hz, hi)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    for name in par_z:
        want = par_i[name].numpy()
        np.testing.assert_allclose(par_z[name].numpy(), want,
                                   atol=max(2e-4 * float(np.abs(want).max()), 3e-5), err_msg=name)


def _grad_share(t_grads, j_grads):
    """Largest error as a share of the reference's largest magnitude, over
    the gradient tensors whose largest magnitude exceeds 1e-2."""
    pairs = [(g, _jax_param_grad(j_grads[0], n)) for n, g in t_grads[0].items()]
    pairs += [(g, np.asarray(w)) for g, w in zip(t_grads[1], j_grads[1:])]
    pairs = [(np.asarray(g), w) for g, w in pairs if float(np.abs(w).max()) > 1e-2]
    return max(float(np.abs(g - w).max()) / float(np.abs(w).max()) for g, w in pairs)


def test_bf16_matches_g8_bf16(monkeypatch, record_property):
    """The measured errors are recorded as test properties (JUnit XML)."""
    params, model = params_pair()
    j_args, t_args = layer_args(numpy_batch(4), params["gnn1"], model.gnn1)
    monkeypatch.setattr(el, "_project", lambda x, w_t, bf16: torch.matmul(x, w_t))
    fn = lambda p, *a: egnn_forward_pallas_lane_vjp(p, *a, interpret=True, bf16=True, g8=True)
    j_out = fn(params["gnn1"], *j_args)
    t_out, t_params, t_inputs = _loss_torch(model.gnn1, t_args, bf16=True)
    (tf, tt, th), (jf, jt, jh) = t_out, j_out
    for name, a, b in (("q", tf.quats, jf.quats), ("t", tf.trans, jf.trans), ("tors", tt, jt),
                       ("feat", th, jh)):
        record_property(f"value_err_{name}", float(np.abs(a.detach().numpy() - np.asarray(b)).max()))
    _assert_values_close(t_out, j_out, BF16_VAL_TOL)
    np.testing.assert_allclose(np.linalg.norm(tf.quats.detach().numpy(), axis=-1), 1.0, atol=1e-5)
    g8_grads = _loss_jax(fn, params["gnn1"], j_args)
    f32_grads = _loss_jax(j_egnn_forward, params["gnn1"], j_args)
    record_property("grad_share_vs_g8", _grad_share((t_params, t_inputs), g8_grads))
    record_property("grad_share_vs_fp32", _grad_share((t_params, t_inputs), f32_grads))
    g8_params = {n: _jax_param_grad(g8_grads[0], n) for n in t_params}
    record_property("g8_grad_share_vs_fp32", _grad_share((g8_params, g8_grads[1:]), f32_grads))
    for ref in (g8_grads, f32_grads):
        _assert_grads_close(t_params, t_inputs, ref, rel=BF16_GRAD_REL, floor=BF16_GRAD_FLOOR)


def _loop_inputs(layer, t_args, seed=0):
    """The loop's ten inputs (port layout, fp32) for one layer, and
    cotangents of (D, GD, TA, TR, HID) from ``seed``."""
    frames, tors, h, edge_pre, mask, ph, pf, pm = t_args
    B, N, H = h.shape
    P = pm.shape[-1]
    msg0 = layer.message_mlp[0]
    with torch.no_grad():
        args = (
            el.loop_weights(layer),
            h @ msg0.weight[:, :H].T + msg0.bias,
            tors.reshape(B, N, 14) @ layer.torsion_mlp[0].weight[:, 64:].T,
            frames.quats, frames.trans,
            torch.cat((h, ph), 1) @ msg0.weight[:, H:2 * H].T,
            torch.cat((frames.quats, pf.quats), 1), torch.cat((frames.trans, pf.trans), 1),
            torch.nn.functional.pad(edge_pre, (0, 0, 0, P)), message_mask(mask, pm))
    rng = np.random.default_rng(seed)
    cts = [torch.from_numpy(rng.normal(size=(B, N) + s).astype(np.float32))
           for s in ((), (4,), (7,), (3,), (T,))]
    return [x.contiguous() for x in args], cts


def _jax_loop_vjp(args, cts):
    """The JAX loop's outputs and its custom VJP's cotangents (g8 kernels,
    fp32, interpret mode) for port-layout inputs, back in port layout."""
    w, a_i, tor, q_i, t_i, a_j, q_j, t_j, edge, mask = [x.numpy() for x in args]
    B, N, NP = mask.shape
    k, Bp, _, _ = _cell_geometry(B, N, 1024)
    v = {n: x.numpy() for n, x in el.loop_views(torch.from_numpy(w)).items()}
    w2all, b2all = np.zeros((32, 4 * T), np.float32), np.zeros((32, 1), np.float32)
    for sec, (name, (row, rows)) in enumerate(HEAD_OUT.items()):
        lo = {"att": 0, "rot": 1, "tor": 5, "transl": 12}[name]
        w2all[row:row + rows, sec * T:(sec + 1) * T] = v["w2"][lo:lo + rows]
        b2all[row:row + rows, 0] = v["b2"][lo:lo + rows]
    col = lambda x: jnp.asarray(x.reshape(-1, 1))
    loop_w = {"whm": jnp.asarray(v["whm"]), "wad": col(v["wad"]), "waq": col(v["waq"]),
              "ba1": col(v["ba1"]), "w2all": jnp.asarray(w2all), "b2all": jnp.asarray(b2all),
              "bl1": col(v["bl1"]), "wrq": jnp.asarray(v["wrq"]), "br1": col(v["br1"]),
              "bt1": col(v["bt1"])}
    mask3 = np.pad(mask, ((0, Bp - B), (0, 0), (0, 0))).transpose(2, 1, 0).reshape(NP, 1, N * Bp)
    qjg_cm = nbr_to_cm8(jnp.asarray(q_j), Bp)
    extra = (jnp.asarray(mask3), lane_s_mat(k, Bp), lane_j_mat(k, Bp),
             jnp.zeros((14, N * Bp), jnp.float32), jnp.zeros((4 * T, T + 21), jnp.float32))
    loop = _loop_fn(k, Bp, NP, T, 64, False, 1, True, True, False, False)
    nl = lambda x: node_to_lane(jnp.asarray(x), Bp)
    nbl = lambda x: nbr_to_lane(jnp.asarray(x), Bp)

    def f(lw, ai, tr, qi, ti, aj, qj, tj, e3):
        return loop(lw, ai, tr, qi, ti, aj, qj, tj, qjg_cm, e3, *extra)

    outs, vjp = jax.vjp(f, loop_w, nl(a_i), nl(tor), nl(q_i), nl(t_i), nbl(a_j), nbl(q_j),
                        nbl(t_j), jnp.asarray(edge.transpose(1, 0, 2)))
    z = jnp.zeros((1, N * Bp), jnp.float32)
    g = vjp((z,) + tuple(nl(c.numpy()) for c in cts) + (z,))
    back = lambda x: np.asarray(lane_to_node(x, B, Bp))
    nbr_back = lambda x: np.asarray(x).transpose(2, 0, 1)[:B]
    dw = g[0]
    w2 = np.asarray(dw["w2all"])
    dw_np = {n: np.asarray(dw[n]).reshape(v[n].shape) for n in v if n not in ("w2", "b2")}
    dw_np["w2"] = np.concatenate([w2[row:row + rows, sec * T:(sec + 1) * T]
                                  for sec, (row, rows) in enumerate(HEAD_OUT.values())])
    dw_np["b2"] = np.concatenate([np.asarray(dw["b2all"])[row:row + rows, 0]
                                  for row, rows in HEAD_OUT.values()])
    grads = [dw_np, back(g[1]), back(g[2]), back(g[3]), back(g[4]), nbr_back(g[5]),
             nbr_back(g[6]), nbr_back(g[7]), np.asarray(g[8]).transpose(1, 0, 2)]
    return [back(o) for o in outs], grads


def test_plain_loop_backward_matches_jax_custom_vjp():
    """Autograd through ``egnn_loop_plain`` against the JAX loop's
    hand-written VJP: every cotangent output, weight by weight, and the
    seven forward accumulators."""
    params, model = params_pair(seed=1)
    _, t_args = layer_args(numpy_batch(4, seed=2), params["gnn2"], model.gnn2, inner=True)
    args, cts = _loop_inputs(model.gnn2, t_args)
    j_outs, j_grads = _jax_loop_vjp(args, cts)
    inp = [x.clone().requires_grad_(True) for x in args[:9]]
    outs = el.egnn_loop_plain(*inp, args[9])
    grads = torch.autograd.grad(outs[1:6], inp, cts)
    tol = lambda ref: max(2e-4 * float(np.abs(ref).max()), 3e-5)
    for name, o, jo in zip(el.OUT_NAMES, outs, j_outs):
        np.testing.assert_allclose(o.detach().numpy().reshape(jo.shape), jo, atol=tol(jo),
                                   rtol=1e-5, err_msg=name)
    for name, g in el.loop_views(grads[0]).items():
        want = j_grads[0][name]
        np.testing.assert_allclose(g.numpy(), want, atol=tol(want), err_msg=f"dW {name}")
    for name, g, want in zip(("a_i", "tor_node", "q_i", "t_i", "a_j", "q_j", "t_j", "edge"),
                             grads[1:], j_grads[1:]):
        np.testing.assert_allclose(g.numpy(), want.reshape(g.shape), atol=tol(want),
                                   err_msg=f"d{name}")


def test_loop_weights_are_differentiable_folds():
    """``loop_weights`` is the fold of the layer's parameters (whm =
    wheads @ wm2, wm2's bias in the head biases) and carries their
    gradient back."""
    _, model = params_pair(seed=3)
    layer = model.gnn1
    v = el.loop_views(el.loop_weights(layer))
    att0, msg2 = layer.attention_mlp[0], layer.message_mlp[2]
    wheads = torch.cat((att0.weight[:, :64], layer.rotation_mlp[0].weight[:, :64],
                        layer.torsion_mlp[0].weight[:, :64], layer.translation_mlp[0].weight))
    with torch.no_grad():
        np.testing.assert_allclose(v["whm"].numpy(), (wheads @ msg2.weight).numpy(), atol=1e-6)
        np.testing.assert_allclose(v["ba1"].numpy(), (att0.bias + wheads[:64] @ msg2.bias).numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(v["w2"][12].numpy(), layer.translation_mlp[2].weight[0].numpy())
    g = torch.autograd.grad(v["whm"].sum() + v["b2"].sum(), [msg2.weight, layer.torsion_mlp[2].bias])
    np.testing.assert_allclose(g[0].numpy(), wheads.sum(0)[:, None].expand(64, 64).detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(g[1].numpy(), np.ones(7))


def test_wrapper_checks_and_cpu_route():
    params, model = params_pair()
    _, t_args = layer_args(numpy_batch(2), params["gnn1"], model.gnn1)
    args, _ = _loop_inputs(model.gnn1, t_args)
    el.reset_launches()
    el.egnn_loop(*args)
    el.egnn_loop(*args, bf16="high")
    assert el.LAUNCHES == {"fwd_fp32": 0, "fwd_bf16": 0, "fwd_high": 0, "bwd_fp32": 0, "bwd_bf16": 0,
                           "bwd_high": 0}
    bad = list(args)
    bad[5] = bad[5][:, :-1].contiguous()  # a_j with NP - 1 neighbours
    with pytest.raises(ValueError):
        el.egnn_loop(*bad)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        el.egnn_loop(*bad)
    bad = list(args)
    bad[8] = bad[8].transpose(0, 1).contiguous().transpose(0, 1)  # non-contiguous edge
    with pytest.raises(ValueError):
        el.egnn_loop(*bad)
    bad = list(args)
    bad[0] = bad[0][:-1]  # loop weights one short
    with pytest.raises(ValueError):
        el.egnn_loop(*bad)
