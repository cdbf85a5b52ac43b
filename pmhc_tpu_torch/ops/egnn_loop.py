"""The training layer: pre-projections, the neighbour loop (forward and
backward kernels of ``csrc/egnn_loop.cu``) and the autodiffed finalize.

Counterpart of ``pmhc_tpu/ops/egnn_pallas_lane_vjp.py::
egnn_forward_pallas_lane_vjp`` on the ``[B, N, C]`` layout. Only the
O(B·N·NP) neighbour loop is a kernel; the per-node stages around it are
plain differentiable torch, so autograd carries them and
``EGNNLoopFn.backward`` supplies the loop's own gradients:

    torch pre-projections  ->  neighbour loop (EGNNLoopFn)      ->  torch finalize
    a_i, a_j, tor_node         m, D, GD[4], TA[7], TR[3],           feature MLP, quat /
                               HID[T], CNT per query row            torsion / translation

The loop consumes the ten loop weights ``LOOP_W`` (``loop_weights``): the
message lin2 folded into the four head lin1 blocks (``whm = wheads @ wm2``,
its bias into ``ba1/br1/bt1/bl1``), the attention's distance and
quat-dot columns, the rotation head's quat block ``wrq`` and the four head
lin2 layers as 13 rows (``w2``, ``b2``). They are built with
differentiable fp32 ops, packed into one flat buffer, and their gradient
flows back onto the layer's parameters through autograd.

Modes (``bf16`` as in ``ops/egnn_fused.py::mode_of``: False, True,
``"high"``): fp32 (IEEE fp32), bf16 (the loop's matmul operands rounded to
bf16, fp32 sums; the node projections ``a_i``, ``tor_node`` and the
finalize's matmuls take one bf16 pass, ``a_j`` stays fp32, as in the JAX
package's ``--bf16`` training path) and high (``--fast-f32``: the loop's
head and lin2 products, and in the backward every product the bf16 mode
runs on the tensor cores, with both operands split into bf16 halves,
hi@hi + hi@lo + lo@hi; the rotation term, the node projections and the
finalize in IEEE fp32, which is what the JAX package's ``Precision.HIGH``
matmuls give on the CPU). ``EGNNLoopFn`` launches the kernels on CUDA
tensors and takes ``egnn_loop_plain`` (forward) and autograd through it
(backward) on CPU tensors; the plain version's splits pass gradients
through, so its backward multiplies in fp32 where the high kernel splits.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from pmhc_tpu_torch.geometry import (
    RigidArray,
    identity_quat,
    multiply_sin_cos,
    quat_conjugate,
    quat_multiply,
    torch_normalize,
)
from pmhc_tpu_torch.models.egnn import INFINITY, N_TORSIONS, TRANSITION, EGNNLayer, message_mask
from pmhc_tpu_torch.ops.egnn_fused import (
    LIN2_ROWS,
    FLAGS,
    MODE_IDS,
    _bf16_round,
    _check,
    _project,
    _split_mm,
    device_ctx,
    mode_of,
)

T = TRANSITION
# the loop weights in buffer order, the order of ``LoopW`` in
# ``csrc/egnn_loop.cu``
LOOP_W: List[Tuple[str, Tuple[int, ...]]] = [
    ("whm", (4 * T, T)), ("wad", (T,)), ("waq", (T,)), ("ba1", (T,)),
    ("br1", (T,)), ("bt1", (T,)), ("bl1", (T,)), ("wrq", (T, 4)),
    ("w2", (13, T)), ("b2", (13,)),
]
LOOP_W_SIZE = sum(torch.Size(s).numel() for _, s in LOOP_W)
OUT_NAMES = ("m", "D", "GD", "TA", "TR", "HID", "CNT")

# kernel launches on the main path, per kernel and mode
# (a CUDA graph's capture takes its counts back and each replay adds them:
# utils/graphs.py)
LAUNCHES = {f"{kind}_{mode}": 0 for kind in ("fwd", "bwd") for mode in MODE_IDS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def loop_weights(layer: EGNNLayer) -> torch.Tensor:
    """The ten loop weights of one layer, folded with differentiable fp32
    ops and packed into one flat ``[LOOP_W_SIZE]`` buffer."""
    att0, att2 = layer.attention_mlp[0], layer.attention_mlp[2]
    rot0, rot2 = layer.rotation_mlp[0], layer.rotation_mlp[2]
    tor0, tor2 = layer.torsion_mlp[0], layer.torsion_mlp[2]
    trl0, trl2 = layer.translation_mlp[0], layer.translation_mlp[2]
    msg2 = layer.message_mlp[2]
    M = msg2.out_features
    if layer.message_mlp[0].out_features != T:
        raise ValueError(f"loop layer needs hidden width {T}, got {layer.message_mlp[0].out_features}")
    wheads = torch.cat((att0.weight[:, :M], rot0.weight[:, :M], tor0.weight[:, :M],
                        trl0.weight), dim=0)                                  # [4T, M]
    bhm = wheads @ msg2.bias                                                  # [4T]
    parts = {
        "whm": wheads @ msg2.weight,
        "wad": att0.weight[:, M], "waq": att0.weight[:, M + 1],
        "ba1": att0.bias + bhm[0:T], "br1": rot0.bias + bhm[T:2 * T],
        "bt1": tor0.bias + bhm[2 * T:3 * T], "bl1": trl0.bias + bhm[3 * T:],
        "wrq": rot0.weight[:, M:],
        "w2": torch.cat((att2.weight, rot2.weight, tor2.weight, trl2.weight)),
        "b2": torch.cat((att2.bias, rot2.bias, tor2.bias, trl2.bias)),
    }
    return torch.cat([parts[n].reshape(-1) for n, _ in LOOP_W])


def loop_views(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Named views of a flat loop-weight buffer (or of its gradient)."""
    out, p = {}, 0
    for name, shape in LOOP_W:
        n = torch.Size(shape).numel()
        out[name] = buf[p:p + n].view(shape)
        p += n
    return out


def egnn_loop_plain(w: torch.Tensor, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask,
                    bf16=False):
    """The loop kernel's function written densely over [B, N, NP, T]:
    ``(m, D, GD, TA, TR, HID, CNT)`` per query row. ``m`` is the running
    max the kernel ends with (detached: the accumulators' users divide it
    out); ``HID`` sums relu(pre) over all NP slots, masked included."""
    v = loop_views(w)
    mode = mode_of(bf16)
    r = _bf16_round if mode == "bf16" else (lambda x: x)

    def mm(x, wt):  # x [..., in] @ wt[out, in].T
        return torch.matmul(r(x), r(wt).T)

    def mmk(x, wt):  # the kernels' tensor-core products: split in high mode
        return _split_mm(x, wt) if mode == "high" else mm(x, wt)

    hid = torch.relu(a_i[:, :, None] + a_j[:, None] + edge[None])      # [B, N, NP, T]
    qi_b, qj_b = q_i[:, :, None], q_j[:, None]
    dx = t_i[:, :, None] - t_j[:, None]                                 # [B, N, NP, 3]
    d2 = torch.sum(dx * dx, dim=-1)
    qdot2 = torch.sum(qi_b * qj_b, dim=-1) ** 2
    # zero-quat guard: padded frames may carry all-zero quats
    inv_qj = quat_conjugate(qj_b) / torch.clamp(torch.sum(qj_b * qj_b, -1, keepdim=True), min=1e-30)
    local_q = quat_multiply(inv_qj, quat_multiply(qi_b, qj_b))

    heads = mmk(hid, v["whm"])                                          # [B, N, NP, 4T]
    att = heads[..., :T] + (v["wad"] * (-d2)[..., None] + v["waq"] * qdot2[..., None] + v["ba1"])
    rot = heads[..., T:2 * T] + (mm(local_q, v["wrq"]) + v["br1"])
    tor = heads[..., 2 * T:3 * T] + (tor_node[:, :, None] + v["bt1"])
    trl = heads[..., 3 * T:] + v["bl1"]

    def lin2(act, name):
        lo, hi = LIN2_ROWS[name]
        return mmk(torch.relu(act), v["w2"][lo:hi]) + v["b2"][lo:hi]

    logit = lin2(att, "att")[..., 0] - (1.0 - msg_mask) * INFINITY     # [B, N, NP]
    m = torch.clamp(logit.detach().amax(dim=-1), min=-1e30)
    e = torch.exp(logit - m[..., None])[..., None]
    # sigmoid output used UNNORMALIZED
    gdelta = quat_multiply(qj_b, quat_multiply(torch.sigmoid(lin2(rot, "rot")), inv_qj))
    mr = lin2(trl, "transl") * dx
    return (m, torch.sum(e[..., 0], dim=-1), torch.sum(e * gdelta, dim=-2),
            torch.sum(e * lin2(tor, "tor"), dim=-2), torch.sum(e * mr, dim=-2),
            torch.sum(hid, dim=2), torch.sum(msg_mask, dim=-1))


def _lib():
    from pmhc_tpu_torch.ops import _build

    return bind(_build.load("egnn_loop"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/egnn_loop.cu`` on a loaded library
    and check its weight layout against ``LOOP_W`` (once per library)."""
    if not getattr(lib, "_pmhc_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.egnn_loop_fwd_launch.argtypes = [ptr] * 17 + [i32] * 4 + [ptr]
        lib.egnn_loop_bwd_launch.argtypes = [ptr] * 26 + [i32] * 5 + [ptr]
        lib.egnn_loop_bwd_blocks.argtypes = [i32]
        lib.egnn_loop_weights_size.argtypes = []
        for fn in (lib.egnn_loop_fwd_launch, lib.egnn_loop_bwd_launch,
                   lib.egnn_loop_bwd_blocks, lib.egnn_loop_weights_size):
            fn.restype = i32
        if lib.egnn_loop_weights_size() != LOOP_W_SIZE:
            raise ValueError("egnn_loop: loop-weight layout differs from the kernel's")
        lib._pmhc_typed = True
    return lib


def launch_fwd(lib, w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask, bf16,
               stream: int = 0):
    """One launch of the forward kernel on checked inputs; returns the seven
    accumulators. ``stream`` is the CUDA stream handle (0: the default)."""
    B, N, NP = msg_mask.shape
    new = lambda *s: torch.empty((B, N) + s, dtype=torch.float32, device=a_i.device)
    outs = (new(), new(), new(4), new(N_TORSIONS), new(3), new(T), new())
    err = lib.egnn_loop_fwd_launch(
        *(x.data_ptr() for x in (w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask) + outs),
        B, N, NP, MODE_IDS[mode_of(bf16)], stream)
    if err != 0:
        raise RuntimeError(f"egnn_loop forward kernel launch failed: CUDA error {err}")
    return outs


def launch_bwd(lib, w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask, m, cts,
               bf16, stream: int = 0):
    """One launch of the backward kernel (and its weight-gradient
    reduction) on checked inputs. ``cts``: the cotangents of (D, GD, TA,
    TR, HID), contiguous. Returns (dw, da_i, dtor_node, dq_i, dt_i, da_j,
    dq_j, dt_j, dedge)."""
    B, N, NP = msg_mask.shape
    dev = a_i.device
    like = lambda x: torch.empty(x.shape, dtype=torch.float32, device=dev)
    grads = tuple(like(x) for x in (a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge))
    dw = torch.empty(LOOP_W_SIZE, dtype=torch.float32, device=dev)
    # one slice of weight-gradient partial sums per block
    blocks = lib.egnn_loop_bwd_blocks(B * N)
    if blocks < 1:
        raise RuntimeError("egnn_loop: no backward launch configuration for this device")
    partial = torch.empty(blocks * LOOP_W_SIZE, dtype=torch.float32, device=dev)
    err = lib.egnn_loop_bwd_launch(
        *(x.data_ptr() for x in (w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask, m)
          + tuple(cts) + grads + (dw, partial)),
        B, N, NP, MODE_IDS[mode_of(bf16)], blocks, stream)
    if err != 0:
        raise RuntimeError(f"egnn_loop backward kernel launch failed: CUDA error {err}")
    return (dw,) + grads


def _check_inputs(w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask) -> None:
    B, N, NP = msg_mask.shape
    dev = a_i.device
    for name, x, shape in (
            ("w", w, (LOOP_W_SIZE,)), ("a_i", a_i, (B, N, T)), ("tor_node", tor_node, (B, N, T)),
            ("q_i", q_i, (B, N, 4)), ("t_i", t_i, (B, N, 3)), ("a_j", a_j, (B, NP, T)),
            ("q_j", q_j, (B, NP, 4)), ("t_j", t_j, (B, NP, 3)), ("edge", edge, (N, NP, T)),
            ("msg_mask", msg_mask, (B, N, NP))):
        _check(name, x, shape, dev, who="egnn_loop")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"egnn_loop: unsupported device {dev}")


class EGNNLoopFn(torch.autograd.Function):
    """The neighbour loop with its hand-written backward. Inputs: the flat
    loop weights, ``a_i``, ``tor_node`` [B, N, T], ``q_i`` [B, N, 4],
    ``t_i`` [B, N, 3], ``a_j`` [B, NP, T], ``q_j`` [B, NP, 4], ``t_j``
    [B, NP, 3], ``edge`` [N, NP, T], ``msg_mask`` [B, N, NP] (no
    gradient), ``bf16`` (False, True or ``"high"``). ``m`` and ``CNT``
    carry no gradient: the finalize
    uses only ratios of the accumulators and a test of CNT."""

    @staticmethod
    def forward(ctx, w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask, bf16):
        args = (w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask)
        _check_inputs(*args)
        if a_i.device.type == "cpu":
            with torch.no_grad():
                outs = egnn_loop_plain(*args, bf16=bf16)
        else:
            with device_ctx(a_i.device):
                outs = launch_fwd(_lib(), *args, bf16=bf16,
                                  stream=torch.cuda.current_stream(a_i.device).cuda_stream)
            LAUNCHES["fwd_" + mode_of(bf16)] += 1
        ctx.save_for_backward(*args, outs[0])
        ctx.bf16 = bf16
        ctx.mark_non_differentiable(outs[0], outs[6])
        return outs

    @staticmethod
    def backward(ctx, _gm, g_d, g_gd, g_ta, g_tr, g_hid, _gcnt):
        *args, m = ctx.saved_tensors
        shapes = [m.shape + s for s in ((), (4,), (N_TORSIONS,), (3,), (T,))]
        cts = [torch.zeros(s, dtype=torch.float32, device=m.device) if g is None
               else g.contiguous() for g, s in zip((g_d, g_gd, g_ta, g_tr, g_hid), shapes)]
        if m.device.type == "cpu":
            with torch.enable_grad():
                inp = [x.detach().requires_grad_(True) for x in args[:9]]
                outs = egnn_loop_plain(*inp, args[9], bf16=ctx.bf16)
                grads = torch.autograd.grad(outs[1:6], inp, cts, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inp)]
        else:
            with device_ctx(m.device):
                grads = launch_bwd(_lib(), *args, m, cts, bf16=ctx.bf16,
                                   stream=torch.cuda.current_stream(m.device).cuda_stream)
            LAUNCHES["bwd_" + mode_of(ctx.bf16)] += 1
        return (*grads, None, None)


def egnn_loop(w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask, bf16=False):
    """``EGNNLoopFn.apply``: the seven accumulators, differentiable in
    everything but ``msg_mask``."""
    return EGNNLoopFn.apply(w, a_i, tor_node, q_i, t_i, a_j, q_j, t_j, edge, msg_mask,
                            FLAGS[mode_of(bf16)])


def egnn_forward_loop(layer: EGNNLayer, peptide_frames: RigidArray, peptide_torsions,
                      peptide_features, edge_pre, peptide_mask, pocket_features,
                      pocket_frames: RigidArray, pocket_mask, bf16=False):
    """Differentiable drop-in for ``models.egnn.egnn_forward``: the
    pre-projections, the neighbour loop and the finalize. Returns
    ``(frames, torsions, node features)``."""
    B, N = peptide_mask.shape
    P = pocket_mask.shape[-1]
    NP = N + P
    H = peptide_features.shape[-1]
    msg0, msg2 = layer.message_mlp[0], layer.message_mlp[2]
    M = msg2.out_features
    c = lambda x: x.contiguous()

    a_i = _project(peptide_features, msg0.weight[:, :H].T, bf16) + msg0.bias
    h_all = torch.cat((peptide_features, pocket_features), dim=-2)
    a_j = torch.matmul(h_all, msg0.weight[:, H:2 * H].T)                # always fp32
    tors_flat = peptide_torsions.reshape(B, N, 2 * N_TORSIONS)
    tor_node = _project(tors_flat, layer.torsion_mlp[0].weight[:, M:].T, bf16)
    q_i, t_i = peptide_frames.quats, peptide_frames.trans
    q_all = torch.cat((q_i, pocket_frames.quats), dim=-2)
    t_all = torch.cat((t_i, pocket_frames.trans), dim=-2)
    edge = F.pad(edge_pre, (0, 0, 0, P))                                # [N, NP, T]
    msg_mask = message_mask(peptide_mask, pocket_mask)

    _, D, GD, TA, TR, HID, CNT = egnn_loop(
        c(loop_weights(layer)), c(a_i), c(tor_node), c(q_i), c(t_i), c(a_j), c(q_all), c(t_all),
        c(edge), c(msg_mask), bf16)

    inv_d = 1.0 / D[..., None]
    # the loop sums relu(pre); the (linear) message lin2 applies once here,
    # over ALL neighbour slots: sum msg = HID @ wm2 + NP * bm2
    msg_sum = _project(HID, msg2.weight.T, bf16) + float(NP) * msg2.bias
    gd = torch_normalize(torch.where((CNT > 0.0)[..., None], GD * inv_d, identity_quat(GD)))
    upd_q = torch_normalize(quat_multiply(gd, q_i))

    fea0, fea2 = layer.feature_mlp[0], layer.feature_mlp[2]
    feat_pre = (_project(peptide_features, fea0.weight[:, :H].T, bf16)
                + _project(msg_sum, fea0.weight[:, H:].T, bf16) + fea0.bias)
    node_out = _project(torch.relu(feat_pre), fea2.weight.T, bf16) + fea2.bias

    delta_a = TA * inv_d
    delta_t = torch.stack((torch.sin(delta_a), torch.cos(delta_a)), dim=-1)
    upd_torsions = multiply_sin_cos(delta_t, peptide_torsions)
    upd_x = t_i + TR * inv_d
    return RigidArray(upd_q, upd_x), upd_torsions, node_out
