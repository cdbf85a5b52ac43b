"""The round-1 fused EGNN layer (backend ``"pallas"``): weight packing, the
plain PyTorch version, the wrapper around the hand-written CUDA kernel
``csrc/egnn_pallas.cu``, and its trainable form.

Counterpart of ``pmhc_tpu/ops/egnn_pallas.py`` (the TPU kernel ``_kernel``,
``egnn_forward_pallas`` and ``egnn_forward_pallas_trainable``). Unlike the
fused layer of ``ops/egnn_fused.py``, nothing is folded: the six MLPs run
as they are, the message lin2 is applied and a ``[NP, M]`` message tile
is materialised per query row, the softmax is exact over all NP
neighbours (max, then exp, then sum), the feature MLP takes the plain sum
of the message over all NP slots (masked included), and the updated
quaternion is normalised twice.

Kernel inputs, all fp32 and contiguous: ``h`` [B, N, H], ``h_all``
[B, NP, H] (peptide first, then pocket), ``q_i`` [B, N, 4], ``t_i``
[B, N, 3], ``q_j`` [B, NP, 4], ``t_j`` [B, NP, 3], ``tors`` [B, N, 7, 2],
``msg_mask`` [B, N, NP], ``edge`` [N, NP, T] (zero toward the pocket)
and the packed weights. Outputs ``(q [B,N,4], t [B,N,3], tors [B,N,7,2],
feat [B,N,O])``.

fp32 only: the JAX package runs this kernel at HIGHEST precision whatever
``--bf16`` or ``--fast-f32`` ask (its score network passes no precision
to the ``pallas`` backend), and so does the port.

A layer's ``PallasContext`` (``pallas_context``) is the one checked entry:
called with the peptide state, it launches the kernel for CUDA tensors
and takes ``egnn_pallas_plain`` only for CPU tensors. ``EGNNPallasFn`` makes the
layer differentiable as the JAX package's custom VJP does: the forward is
the kernel; the backward re-runs the dense layer (``models/egnn.py``)
under autograd and differentiates it (rematerialisation). There is no
backward kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from pmhc_tpu_torch.geometry import RigidArray, quat_conjugate, quat_multiply
from pmhc_tpu_torch.models.egnn import (
    INFINITY,
    N_TORSIONS,
    TRANSITION,
    EGNNLayer,
    egnn_forward,
    message_mask,
)
from pmhc_tpu_torch.ops.egnn_fused import _check, device_ctx

T = TRANSITION
# the six MLPs in the TPU kernel's argument order (``egnn_pallas.py:258-266``)
MLPS = ("message", "attention", "feature", "translation", "rotation", "torsion")

# kernel launches on the main path (the plain version counts nothing)
LAUNCHES = {"fp32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def weight_layout(H: int, E: int, O: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of each packed tensor, in buffer order — the order of
    ``weight_offsets`` in ``csrc/egnn_pallas.cu``. Each MLP is lin1.w
    [in, T], lin1.b [T], lin2.w [T, out], lin2.b [out] (``[in, out]``, the
    JAX package's layout); message width M = T."""
    M = T
    dims = {"message": (2 * H + E, M), "attention": (M + 2, 1), "feature": (H + M, O),
            "translation": (M, 1), "rotation": (M + 4, 4), "torsion": (M + 2 * N_TORSIONS, N_TORSIONS)}
    layout = []
    for name in MLPS:
        n_in, n_out = dims[name]
        layout += [(f"{name}.w1", (n_in, T)), (f"{name}.b1", (T,)),
                   (f"{name}.w2", (T, n_out)), (f"{name}.b2", (n_out,))]
    return layout


@dataclass
class PackedPallas:
    """One layer's six MLPs, unfolded, in one contiguous fp32 buffer."""

    buf: torch.Tensor
    H: int
    E: int
    O: int
    views: Dict[str, torch.Tensor]
    layout_checked: bool = False  # length held against the kernel's layout

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.views[name]


def pack_pallas_weights(layer: EGNNLayer) -> PackedPallas:
    """The layer's 24 weight arrays in the TPU kernel's order, each
    transposed to ``[in, out]``, in one fp32 buffer (not folded)."""
    msg0 = layer.message_mlp[0]
    M = layer.message_mlp[2].out_features
    if msg0.out_features != T or M != T:
        raise ValueError(f"pallas layer needs hidden and message width {T}, got "
                         f"{msg0.out_features} and {M}")
    H = layer.feature_mlp[0].in_features - M
    E = msg0.in_features - 2 * H
    O = layer.feature_mlp[2].out_features
    with torch.no_grad():
        parts = []
        for name in MLPS:
            mlp = getattr(layer, f"{name}_mlp")
            parts += [mlp[0].weight.T, mlp[0].bias, mlp[2].weight.T, mlp[2].bias]
        buf = torch.cat([p.detach().reshape(-1) for p in parts]).to(torch.float32)
        views, p = {}, 0
        for (name, shape), part in zip(weight_layout(H, E, O), parts):
            if tuple(part.shape) != shape:
                raise ValueError(f"{name}: packed shape {tuple(part.shape)} != {shape}")
            n = part.numel()
            views[name] = buf[p:p + n].view(shape)
            p += n
    return PackedPallas(buf, H, E, O, views)


def egnn_pallas_plain(w: PackedPallas, h, h_all, q_i, t_i, q_j, t_j, tors, msg_mask, edge):
    """The kernel's function written step for step as the TPU ``_kernel``
    computes it, densely over [B, N, NP, *]."""
    B, N, H = h.shape
    M = T

    def mlp_hidden(x, name):
        return torch.relu(x + w[f"{name}.b1"])

    # message: block matmuls -> hidden -> M
    mw1 = w["message.w1"]
    pre = (torch.matmul(h, mw1[:H])[:, :, None] + torch.matmul(h_all, mw1[H:2 * H])[:, None]
           + edge[None])
    message = torch.matmul(mlp_hidden(pre, "message"), w["message.w2"]) + w["message.b2"]

    # attention logits -> exact softmax over all NP neighbours
    dx = t_i[:, :, None] - t_j[:, None]                                  # [B, N, NP, 3]
    d2 = torch.sum(dx * dx, dim=-1, keepdim=True)
    qi_b, qj_b = q_i[:, :, None], q_j[:, None]
    qdot2 = torch.sum(qi_b * qj_b, dim=-1, keepdim=True) ** 2
    aw1 = w["attention.w1"]
    att_pre = torch.matmul(message, aw1[:M]) + (-d2) * aw1[M] + qdot2 * aw1[M + 1]
    logits = torch.matmul(mlp_hidden(att_pre, "attention"), w["attention.w2"]) + w["attention.b2"]
    logits = logits - (1.0 - msg_mask[..., None]) * INFINITY            # [B, N, NP, 1]
    logits = logits - torch.amax(logits, dim=-2, keepdim=True)
    expw = torch.exp(logits)
    w3 = expw / torch.sum(expw, dim=-2, keepdim=True)

    # feature update (sum over ALL neighbours, masked included)
    msg_sum = torch.sum(message, dim=-2)                                 # [B, N, M]
    fw1 = w["feature.w1"]
    feat_pre = torch.matmul(h, fw1[:H]) + torch.matmul(msg_sum, fw1[H:])
    feat = torch.matmul(mlp_hidden(feat_pre, "feature"), w["feature.w2"]) + w["feature.b2"]

    # rotation update; zero-quat guard: padded frames may carry all-zero quats
    inv_qj = quat_conjugate(qj_b) / torch.clamp(torch.sum(qj_b * qj_b, -1, keepdim=True), min=1e-30)
    local_quats = quat_multiply(inv_qj, quat_multiply(qi_b, qj_b))       # [B, N, NP, 4]
    rw1 = w["rotation.w1"]
    rot_pre = torch.matmul(message, rw1[:M]) + torch.matmul(local_quats, rw1[M:])
    # sigmoid output used UNNORMALIZED
    local_delta = torch.sigmoid(
        torch.matmul(mlp_hidden(rot_pre, "rotation"), w["rotation.w2"]) + w["rotation.b2"])
    global_delta = quat_multiply(qj_b, quat_multiply(local_delta, inv_qj))
    gd = torch.sum(global_delta * w3, dim=-2)                            # [B, N, 4]
    has_nb = torch.sum(msg_mask, dim=-1, keepdim=True) > 0.0
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=gd.dtype, device=gd.device)
    gd = torch.where(has_nb, gd, identity)
    gd = gd / torch.clamp(torch.sqrt(torch.sum(gd * gd, dim=-1, keepdim=True)), min=1e-12)
    upd_q = quat_multiply(gd, q_i)
    upd_q = upd_q / torch.clamp(torch.sqrt(torch.sum(upd_q * upd_q, dim=-1, keepdim=True)), min=1e-12)

    # torsion update
    tw1 = w["torsion.w1"]
    tor_node = torch.matmul(tors.reshape(B, N, 2 * N_TORSIONS), tw1[M:])  # [B, N, T]
    tor_pre = torch.matmul(message, tw1[:M]) + tor_node[:, :, None]
    m_delta_a = torch.matmul(mlp_hidden(tor_pre, "torsion"), w["torsion.w2"]) + w["torsion.b2"]
    delta_a = torch.sum(m_delta_a * w3, dim=-2)                          # [B, N, 7]
    sin_d, cos_d = torch.sin(delta_a), torch.cos(delta_a)
    sin_t, cos_t = tors[..., 0], tors[..., 1]
    tors_out = torch.stack((sin_d * cos_t + cos_d * sin_t, cos_d * cos_t - sin_d * sin_t), dim=-1)

    # translation update
    tr_hid = mlp_hidden(torch.matmul(message, w["translation.w1"]), "translation")
    m_tr = torch.matmul(tr_hid, w["translation.w2"]) + w["translation.b2"]   # [B, N, NP, 1]
    t_out = t_i + torch.sum((m_tr * w3) * dx, dim=-2)
    return upd_q, t_out, tors_out, feat


def _lib():
    from pmhc_tpu_torch.ops import _build

    return bind(_build.load("egnn_pallas"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/egnn_pallas.cu`` on a loaded
    library (once per library)."""
    if not getattr(lib, "_pmhc_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.egnn_pallas_launch.argtypes = [ptr] * 14 + [i32] * 6 + [ptr]
        lib.egnn_pallas_launch.restype = i32
        lib.egnn_pallas_weights_size.argtypes = [i32] * 3
        lib.egnn_pallas_weights_size.restype = i32
        lib._pmhc_typed = True
    return lib


def _check_weights(w: PackedPallas, device: torch.device) -> None:
    """The packed buffer on ``device``, and — once per buffer, on the card —
    its length against the kernel's own layout."""
    _check("weights", w.buf, w.buf.shape, device, who="egnn_pallas")
    if not 1 <= w.H <= T:
        raise ValueError(f"egnn_pallas: input width {w.H} outside [1, {T}]")
    if device.type == "cuda" and not w.layout_checked:
        if _lib().egnn_pallas_weights_size(w.H, w.E, w.O) != w.buf.numel():
            raise ValueError("egnn_pallas: packed weight buffer does not match the kernel's layout")
        w.layout_checked = True


def launch(lib, w: PackedPallas, h, h_all, q_i, t_i, q_j, t_j, tors, msg_mask, edge,
           stream: int = 0):
    """One launch of the kernel on checked inputs; returns (q, t, tors,
    feat). ``stream`` is the CUDA stream handle (0: the default)."""
    B, N, NP = msg_mask.shape
    dev = h.device
    new = lambda *s: torch.empty((B, N) + s, dtype=torch.float32, device=dev)
    outs = (new(4), new(3), new(N_TORSIONS, 2), new(w.O))
    err = lib.egnn_pallas_launch(
        *(x.data_ptr() for x in (w.buf, h, h_all, q_i, t_i, q_j, t_j, tors, msg_mask, edge) + outs),
        B, N, NP, w.H, w.E, w.O, stream)
    if err != 0:
        raise RuntimeError(f"egnn_pallas kernel launch failed: CUDA error {err}")
    return outs


def _run(w: PackedPallas, h, h_all, q_i, t_i, q_j, t_j, tors, msg_mask, edge):
    """Checked inputs -> the plain version (CPU) or one kernel launch (CUDA)."""
    if h.device.type == "cpu":
        return egnn_pallas_plain(w, h, h_all, q_i, t_i, q_j, t_j, tors, msg_mask, edge)
    if h.device.type != "cuda":
        raise ValueError(f"egnn_pallas: unsupported device {h.device}")
    with device_ctx(h.device):
        out = launch(_lib(), w, h, h_all, q_i, t_i, q_j, t_j, tors, msg_mask, edge,
                     torch.cuda.current_stream(h.device).cuda_stream)
    LAUNCHES["fp32"] += 1
    return out


def _check_step(w: PackedPallas, h, q_i, t_i, tors, B: int, N: int, dev) -> None:
    for name, x, shape in (("h", h, (B, N, w.H)), ("q_i", q_i, (B, N, 4)), ("t_i", t_i, (B, N, 3)),
                           ("tors", tors, (B, N, N_TORSIONS, 2))):
        _check(name, x, shape, dev, who="egnn_pallas")


@dataclass
class PallasContext:
    """One layer's inputs that stay fixed over a trajectory, checked once:
    the packed weights, the pocket halves of ``h_all`` [B, P, H], ``q_j``
    and ``t_j``, the edge terms [N, NP, T] and the message mask [B, N, NP].
    Calling it with the peptide state runs the layer; only those per-step
    tensors are checked then."""

    w: PackedPallas
    h_pocket: torch.Tensor
    q_pocket: torch.Tensor
    t_pocket: torch.Tensor
    edge: torch.Tensor
    msg_mask: torch.Tensor

    def inputs(self, h, q, t, tors):
        """The kernel's ten inputs for this peptide state."""
        return (self.w, h, torch.cat((h, self.h_pocket), dim=1), q, t,
                torch.cat((q, self.q_pocket), dim=1), torch.cat((t, self.t_pocket), dim=1),
                tors, self.msg_mask, self.edge)

    def __call__(self, h, q, t, tors):
        B, N, _ = self.msg_mask.shape
        _check_step(self.w, h, q, t, tors, B, N, self.edge.device)
        return _run(*self.inputs(h, q, t, tors))


def pallas_context(layer: EGNNLayer, edge_pre, mask, pocket_features, pocket_frames: RigidArray,
                   pocket_mask) -> PallasContext:
    """Pack and check one layer's static inputs: ``edge_pre`` [N, N, T],
    ``mask`` [B, N], ``pocket_features`` [B, P, H] (the layer's input
    width), ``pocket_mask`` [B, P]."""
    B, N = mask.shape
    P, H = pocket_mask.shape[-1], pocket_features.shape[-1]
    with torch.no_grad():
        ctx = PallasContext(
            w=pack_pallas_weights(layer), h_pocket=pocket_features.contiguous(),
            q_pocket=pocket_frames.quats.contiguous(), t_pocket=pocket_frames.trans.contiguous(),
            edge=F.pad(edge_pre, (0, 0, 0, P)).contiguous(),
            msg_mask=message_mask(mask, pocket_mask).contiguous())
    dev = ctx.edge.device
    if ctx.w.H != H:
        raise ValueError(f"egnn_pallas: pocket features have width {H}, the layer takes {ctx.w.H}")
    _check_weights(ctx.w, dev)
    for name, x, shape in (("h_pocket", ctx.h_pocket, (B, P, H)), ("q_pocket", ctx.q_pocket, (B, P, 4)),
                           ("t_pocket", ctx.t_pocket, (B, P, 3)), ("edge", ctx.edge, (N, N + P, T)),
                           ("msg_mask", ctx.msg_mask, (B, N, N + P))):
        _check(name, x, shape, dev, who="egnn_pallas")
    return ctx


def egnn_forward_pallas(layer: EGNNLayer, peptide_frames: RigidArray, peptide_torsions,
                        peptide_features, edge_pre, peptide_mask, pocket_features,
                        pocket_frames: RigidArray, pocket_mask):
    """Forward-only drop-in for ``models.egnn.egnn_forward`` through the
    kernel (``egnn_forward_pallas`` of the JAX package): ``(frames,
    torsions, node features)``."""
    ctx = pallas_context(layer, edge_pre, peptide_mask, pocket_features, pocket_frames, pocket_mask)
    c = lambda x: x.detach().contiguous()
    q, t, tors, feat = ctx(c(peptide_features), c(peptide_frames.quats), c(peptide_frames.trans),
                           c(peptide_torsions))
    return RigidArray(q, t), tors, feat


class EGNNPallasFn(torch.autograd.Function):
    """Kernel forward, rematerialising backward (``_trainable`` of the JAX
    package). Inputs: the layer, the peptide and pocket masks (no
    gradient), the peptide quats, translations, torsions and features,
    ``edge_pre``, the pocket features, quats and translations, then the
    layer's parameters in ``layer.parameters()`` order."""

    @staticmethod
    def forward(ctx, layer, mask, pocket_mask, q, t, tors, feats, edge_pre, pk_feats, pk_q, pk_t,
                *params):
        out = egnn_forward_pallas(layer, RigidArray(q, t), tors, feats, edge_pre, mask, pk_feats,
                                  RigidArray(pk_q, pk_t), pocket_mask)
        ctx.layer = layer
        ctx.save_for_backward(mask, pocket_mask, q, t, tors, feats, edge_pre, pk_feats, pk_q, pk_t)
        return out[0].quats, out[0].trans, out[1], out[2]

    @staticmethod
    def backward(ctx, g_q, g_t, g_tors, g_feat):
        mask, pocket_mask, *xs = ctx.saved_tensors
        layer = ctx.layer
        params = list(layer.parameters())
        with torch.enable_grad():
            inp = [x.detach().requires_grad_(True) for x in xs]
            q, t, tors, feats, edge_pre, pk_feats, pk_q, pk_t = inp
            frames, tors_out, feat = egnn_forward(layer, RigidArray(q, t), tors, feats, edge_pre,
                                                  mask, pk_feats, RigidArray(pk_q, pk_t), pocket_mask)
            grads = torch.autograd.grad((frames.quats, frames.trans, tors_out, feat), inp + params,
                                        (g_q, g_t, g_tors, g_feat), allow_unused=True)
        return (None, None, None, *grads)


def egnn_forward_pallas_trainable(layer: EGNNLayer, peptide_frames: RigidArray, peptide_torsions,
                                  peptide_features, edge_pre, peptide_mask, pocket_features,
                                  pocket_frames: RigidArray, pocket_mask):
    """Differentiable drop-in for ``models.egnn.egnn_forward``: the kernel
    forward, the dense layer's autograd as the backward."""
    q, t, tors, feat = EGNNPallasFn.apply(
        layer, peptide_mask, pocket_mask, peptide_frames.quats, peptide_frames.trans,
        peptide_torsions, peptide_features, edge_pre, pocket_features, pocket_frames.quats,
        pocket_frames.trans, *layer.parameters())
    return RigidArray(q, t), tors, feat
