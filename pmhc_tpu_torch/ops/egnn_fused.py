"""The fused EGNN layer: weight packing, the plain PyTorch version, and the
wrapper around the hand-written CUDA kernel ``csrc/egnn_fused.cu``.

Counterpart of two TPU kernels that compute the same function,
``pmhc_tpu/ops/egnn_pallas_lane.py::_make_kernel`` (f32) and
``pmhc_tpu/ops/egnn_pallas_lane_g8.py::_make_kernel_g8`` (``--bf16``),
without their TPU layouts: inputs and outputs are ``[B, N, C]``.

Inputs are pre-projected: ``h`` [B, N, H] with ``wmi`` (a_i = wmi @ h +
bm1 inside), ``a_j`` [B, NP, T] = h_j @ W1[H:2H] (no bias), neighbour
frames ``q_j`` [B, NP, 4] / ``t_j`` [B, NP, 3] (peptide first, then
pocket), ``edge`` [N, NP, T] (zero toward the pocket) and ``msg_mask``
[B, N, NP]. Outputs ``(q [B,N,4], t [B,N,3], tors [B,N,7,2], feat [B,N,O])``.

Modes, selected by ``bf16`` in the JAX package's convention (``mm_maker``:
False, True, ``"high"``; ``mode_of``): fp32 (IEEE fp32, no TF32; the
kernel's products on the CUDA cores), bf16 (every MLP matmul operand
rounded to bf16, fp32 accumulation; geometry, softmax and fold in fp32;
the kernel's per-neighbour products on the tensor cores) and high
(``--fast-f32``: the two per-neighbour products, whm @ hid and the lin2,
with both operands split into bf16 halves, hi@hi + hi@lo + lo@hi in fp32
on the tensor cores; the rotation term, the node MLPs and the neighbour
projections in fp32, where the TPU kernel splits every matmul: see
``_split_mm``).
``egnn_fused`` launches the kernel for CUDA tensors and takes
``egnn_fused_plain`` only for CPU tensors. ``layer_context`` builds and
checks a layer's static inputs once (the sampler's per-trajectory
context); calling the context checks and runs only the per-step part.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from pmhc_tpu_torch.geometry import (
    RigidArray,
    identity_quat,
    quat_conjugate,
    quat_multiply,
    torch_normalize,
)
from pmhc_tpu_torch.models.egnn import INFINITY, N_TORSIONS, TRANSITION, EGNNLayer, message_mask

T = TRANSITION
# per-head lin2 rows of the packed ``w2`` [13, T]: attention logit,
# rotation sigmoid (4), torsion delta (7), translation scalar
LIN2_ROWS = {"att": (0, 1), "rot": (1, 5), "tor": (5, 12), "transl": (12, 13)}

# kernel launches on the main path, per mode (the plain version counts nothing)
# (a CUDA graph's capture takes its counts back and each replay adds them:
# utils/graphs.py)
LAUNCHES = {"fp32": 0, "bf16": 0, "high": 0}
# the kernels' ``mode`` argument (``csrc/egnn_common.cuh``), and each
# mode's ``bf16`` flag in the JAX package's convention (``mode_of``)
MODE_IDS = {"fp32": 0, "bf16": 1, "high": 2}
FLAGS = {"fp32": False, "bf16": True, "high": "high"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def mode_of(bf16) -> str:
    """The mode of a ``bf16`` flag in the JAX package's convention
    (``mm_maker``): False -> ``"fp32"``, True -> ``"bf16"``, ``"high"`` ->
    ``"high"`` (``--fast-f32``). Anything else raises."""
    if isinstance(bf16, str):
        if bf16 != "high":
            raise ValueError(f"unknown precision mode {bf16!r}: False, True or 'high'")
        return "high"
    return "bf16" if bf16 else "fp32"


def weight_layout(H: int, O: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of each packed tensor, in buffer order — the order of
    ``weight_offsets`` in ``csrc/egnn_fused.cu``."""
    return [
        ("wmi", (T, H)), ("bm1", (T,)), ("whm", (4 * T, T)),
        ("wad", (T,)), ("waq", (T,)), ("ba1", (T,)),
        ("br1", (T,)), ("bt1", (T,)), ("bl1", (T,)),
        ("wrq", (T, 4)), ("wtt", (T, 2 * N_TORSIONS)),
        ("w2", (13, T)), ("b2", (13,)),
        ("wfh", (T, H)), ("wfm2", (T, T)), ("bf1", (T,)),
        ("wf2", (O, T)), ("bf2", (O,)),
    ]


@dataclass
class PackedLayer:
    """One layer's folded weights in one contiguous fp32 buffer."""

    buf: torch.Tensor
    H: int
    O: int
    views: Dict[str, torch.Tensor]
    layout_checked: bool = False  # length held against the kernel's layout

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.views[name]


def pack_layer_weights(layer: EGNNLayer, H: int, NP: int) -> PackedLayer:
    """Fold and pack one layer's weights (``pack_lane_weights`` of the JAX
    package, in torch ``[out, in]`` layout).

    The message MLP's lin2 is consumed only linearly — by the four head
    lin1 blocks and by the all-neighbour sum feeding the feature MLP — so
    it folds into them and one matmul per neighbour disappears:

        whm  = wheads @ wm2        [4T, T]   heads = whm @ relu(pre)
        bhm  = wheads @ bm2        folded into the four head lin1 biases
        wfm2 = wfm @ wm2           [T, T]    feature term = wfm2 @ sum relu(pre)
        bf1' = bf1 + NP * (wfm @ bm2)        (sum over all NP neighbour slots,
                                              masked included)

    The folds are computed in float64 and stored as float32.
    """
    with torch.no_grad():
        d = lambda x: x.detach().to(torch.float64)
        att0, att2 = layer.attention_mlp[0], layer.attention_mlp[2]
        rot0, rot2 = layer.rotation_mlp[0], layer.rotation_mlp[2]
        tor0, tor2 = layer.torsion_mlp[0], layer.torsion_mlp[2]
        trl0, trl2 = layer.translation_mlp[0], layer.translation_mlp[2]
        msg0, msg2 = layer.message_mlp[0], layer.message_mlp[2]
        fea0, fea2 = layer.feature_mlp[0], layer.feature_mlp[2]
        M = msg2.out_features
        if msg0.out_features != T:
            raise ValueError(f"fused layer needs hidden width {T}, got {msg0.out_features}")
        wheads = torch.cat((d(att0.weight[:, :M]), d(rot0.weight[:, :M]),
                            d(tor0.weight[:, :M]), d(trl0.weight)), dim=0)   # [4T, M]
        whm = wheads @ d(msg2.weight)                                         # [4T, T]
        bhm = wheads @ d(msg2.bias)                                           # [4T]
        wfm = d(fea0.weight[:, H:])                                           # [T, M]
        O = fea2.out_features
        parts = {
            "wmi": d(msg0.weight[:, :H]), "bm1": d(msg0.bias), "whm": whm,
            "wad": d(att0.weight[:, M]), "waq": d(att0.weight[:, M + 1]),
            "ba1": d(att0.bias) + bhm[0:T],
            "br1": d(rot0.bias) + bhm[T:2 * T],
            "bt1": d(tor0.bias) + bhm[2 * T:3 * T],
            "bl1": d(trl0.bias) + bhm[3 * T:4 * T],
            "wrq": d(rot0.weight[:, M:]), "wtt": d(tor0.weight[:, M:]),
            "w2": torch.cat((d(att2.weight), d(rot2.weight), d(tor2.weight), d(trl2.weight))),
            "b2": torch.cat((d(att2.bias), d(rot2.bias), d(tor2.bias), d(trl2.bias))),
            "wfh": d(fea0.weight[:, :H]), "wfm2": wfm @ d(msg2.weight),
            "bf1": d(fea0.bias) + float(NP) * (wfm @ d(msg2.bias)),
            "wf2": d(fea2.weight), "bf2": d(fea2.bias),
        }
        layout = weight_layout(H, O)
        buf = torch.cat([parts[n].reshape(-1) for n, _ in layout]).to(torch.float32)
        views, p = {}, 0
        for name, shape in layout:
            n = 1
            for s in shape:
                n *= s
            if tuple(parts[name].shape) != shape:
                raise ValueError(f"{name}: packed shape {tuple(parts[name].shape)} != {shape}")
            views[name] = buf[p:p + n].view(shape)
            p += n
    return PackedLayer(buf, H, O, views)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), as fp32. Its gradient
    passes through unrounded (x + (round(x) - x), exact in fp32): the
    kernels round the operands of their products, never a gradient."""
    r = x.to(torch.bfloat16).to(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def _split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x split into bf16 halves, as fp32: hi = bf16(x), lo = bf16(x - hi)
    (round to nearest even; x - hi is exact)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands split into bf16 halves: hi@hi + hi@lo +
    lo@hi, fp32 sums (lo@lo, ~2^-16 relative, dropped)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


class _SplitMM(torch.autograd.Function):
    """x [..., in] @ wt[out, in].T in split products, forward and backward:
    the gradients are split products too, as the high loop backward and
    the JAX package's high VJP compute them."""

    @staticmethod
    def forward(ctx, x, wt):
        ctx.save_for_backward(x, wt)
        return _split_product(x, wt.T)

    @staticmethod
    def backward(ctx, g):
        x, wt = ctx.saved_tensors
        gx = _split_product(g, wt) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = _split_product(g.reshape(-1, g.shape[-1]).T, x.reshape(-1, x.shape[-1]))
        return gx, gw


def _split_mm(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ wt[out, in].T as the kernels' high mode computes it,
    the JAX package's ``mm_maker("high")``: both operands split into bf16
    halves (``_split``), hi@hi + hi@lo + lo@hi with fp32 sums. Its
    gradients are split products as well (``_SplitMM``), where
    ``_bf16_round`` passes gradients through: the loop backward's products
    are split, and the cancellation in some gradients (d(q_i), the rotation
    head's) amplifies a split's ~2^-17 relative error to ~1e-3 of their
    largest magnitude, so a plain backward in fp32 could not hold the
    kernel to the fp32 tolerances."""
    return _SplitMM.apply(x, wt)


def egnn_fused_plain(w: PackedLayer, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask,
                     bf16=False):
    """The kernel's function written densely over [B, N, NP, T], in each
    mode (same folded weights, same bf16 rounding and split points)."""
    mode = mode_of(bf16)
    r = _bf16_round if mode == "bf16" else (lambda x: x)

    def mm(x, wt):  # x [..., in] @ wt[out, in].T
        return torch.matmul(r(x), r(wt).T)

    def mmk(x, wt):  # the kernel's tensor-core products: split in high mode
        return _split_mm(x, wt) if mode == "high" else mm(x, wt)

    B, N = h.shape[:2]
    a_i = mm(h, w["wmi"]) + w["bm1"]                                   # [B, N, T]
    hid = torch.relu(a_i[:, :, None] + a_j[:, None] + edge[None])       # [B, N, NP, T]

    qi_b, qj_b = q_i[:, :, None], q_j[:, None]
    dx = t_i[:, :, None] - t_j[:, None]                                 # [B, N, NP, 3]
    d2 = torch.sum(dx * dx, dim=-1)
    qdot2 = torch.sum(qi_b * qj_b, dim=-1) ** 2
    # zero-quat guard: padded frames may carry all-zero quats
    inv_qj = quat_conjugate(qj_b) / torch.clamp(torch.sum(qj_b * qj_b, -1, keepdim=True), min=1e-30)
    local_q = quat_multiply(inv_qj, quat_multiply(qi_b, qj_b))         # [B, N, NP, 4]
    tor_node = mm(tors.reshape(B, N, 2 * N_TORSIONS), w["wtt"])         # [B, N, T]

    heads = mmk(hid, w["whm"])                                          # [B, N, NP, 4T]
    att = heads[..., :T] + (w["wad"] * (-d2)[..., None] + w["waq"] * qdot2[..., None] + w["ba1"])
    rot = heads[..., T:2 * T] + (mm(local_q, w["wrq"]) + w["br1"])
    tor = heads[..., 2 * T:3 * T] + (tor_node[:, :, None] + w["bt1"])
    trl = heads[..., 3 * T:] + w["bl1"]

    def lin2(act, name):
        lo, hi = LIN2_ROWS[name]
        return mmk(torch.relu(act), w["w2"][lo:hi]) + w["b2"][lo:hi]

    logits = lin2(att, "att")[..., 0] - (1.0 - msg_mask) * INFINITY     # [B, N, NP]
    weights = torch.softmax(logits, dim=-1)[..., None]
    # sigmoid output used UNNORMALIZED
    gdelta = quat_multiply(qj_b, quat_multiply(torch.sigmoid(lin2(rot, "rot")), inv_qj))
    gd = torch.sum(gdelta * weights, dim=-2)
    has_nb = (torch.sum(msg_mask, dim=-1) > 0.0)[..., None]
    gd = torch_normalize(torch.where(has_nb, gd, identity_quat(gd)))
    q_out = torch_normalize(quat_multiply(gd, q_i))

    delta_a = torch.sum(lin2(tor, "tor") * weights, dim=-2)             # [B, N, 7]
    sin_d, cos_d = torch.sin(delta_a), torch.cos(delta_a)
    sin_t, cos_t = tors[..., 0], tors[..., 1]
    tors_out = torch.stack((sin_d * cos_t + cos_d * sin_t, cos_d * cos_t - sin_d * sin_t), dim=-1)

    t_out = t_i + torch.sum(lin2(trl, "transl") * dx * weights, dim=-2)

    # feature MLP over the plain all-neighbour sum (masked included)
    feat_pre = mm(h, w["wfh"]) + mm(torch.sum(hid, dim=2), w["wfm2"]) + w["bf1"]
    feat = mm(torch.relu(feat_pre), w["wf2"]) + w["bf2"]
    return q_out, t_out, tors_out, feat


def _check(name: str, x: torch.Tensor, shape, device: torch.device, who: str = "egnn_fused") -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{who}: {name} is {x.dtype}, expected float32")
    if x.device != device:
        raise ValueError(f"{who}: {name} on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _check_weights(w: PackedLayer, device: torch.device) -> None:
    """The packed buffer on ``device``, and — once per buffer, on the card —
    its length against the kernel's own layout."""
    _check("weights", w.buf, w.buf.shape, device)
    if not 1 <= w.H <= T:
        raise ValueError(f"egnn_fused: input width {w.H} outside [1, {T}]")
    if device.type == "cuda" and not w.layout_checked:
        if _lib().egnn_fused_weights_size(w.H, w.O) != w.buf.numel():
            raise ValueError("egnn_fused: packed weight buffer does not match the kernel's layout")
        w.layout_checked = True


def _lib():
    from pmhc_tpu_torch.ops import _build

    return bind(_build.load("egnn_fused"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/egnn_fused.cu`` on a loaded
    library (once per library)."""
    if not getattr(lib, "_pmhc_typed", False):
        ptr = ctypes.c_void_p
        lib.egnn_fused_launch.argtypes = [ptr] * 14 + [ctypes.c_int] * 6 + [ptr]
        lib.egnn_fused_launch.restype = ctypes.c_int
        lib.egnn_fused_weights_size.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.egnn_fused_weights_size.restype = ctypes.c_int
        lib._pmhc_typed = True
    return lib


def device_ctx(dev: torch.device):
    """The launch goes to the current device: switch only when the tensors
    lie elsewhere."""
    switch = dev.index is not None and dev.index != torch.cuda.current_device()
    return torch.cuda.device(dev) if switch else contextlib.nullcontext()


def launch(lib, w: PackedLayer, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask, bf16,
           stream: int = 0):
    """One launch of the kernel on checked inputs; returns (q, t, tors,
    feat). ``stream`` is the CUDA stream handle (0: the default). Inputs
    may start at any 4-byte aligned address: the kernel copies a_j, q_j and
    edge in 16-byte pieces where they start 16-byte aligned and in 4-byte
    pieces where they do not (no copy into fresh storage here)."""
    B, N, NP = msg_mask.shape
    dev = h.device
    out_q = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    out_t = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    out_tors = torch.empty((B, N, N_TORSIONS, 2), dtype=torch.float32, device=dev)
    out_feat = torch.empty((B, N, w.O), dtype=torch.float32, device=dev)
    err = lib.egnn_fused_launch(
        *(x.data_ptr() for x in (w.buf, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask,
                                 out_q, out_t, out_tors, out_feat)),
        B, N, NP, w.H, w.O, MODE_IDS[mode_of(bf16)], stream)
    if err != 0:
        raise RuntimeError(f"egnn_fused kernel launch failed: CUDA error {err}")
    return out_q, out_t, out_tors, out_feat


def _run(w: PackedLayer, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask, bf16):
    """Checked inputs -> the plain version (CPU) or one kernel launch (CUDA)."""
    if h.device.type == "cpu":
        return egnn_fused_plain(w, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask, bf16)
    if h.device.type != "cuda":
        raise ValueError(f"egnn_fused: unsupported device {h.device}")
    dev = h.device
    with device_ctx(dev):
        out = launch(_lib(), w, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask, bf16,
                     torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[mode_of(bf16)] += 1
    return out


def egnn_fused(w: PackedLayer, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask,
               bf16=False):
    """The fused layer: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``bf16``: False, True or ``"high"`` (``mode_of``).
    Raises on anything the kernel does not take."""
    B, N, _ = h.shape
    NP = a_j.shape[1]
    dev = h.device
    _check_weights(w, dev)
    for name, x, shape in (
            ("h", h, (B, N, w.H)), ("q_i", q_i, (B, N, 4)), ("t_i", t_i, (B, N, 3)),
            ("tors", tors, (B, N, N_TORSIONS, 2)), ("a_j", a_j, (B, NP, T)),
            ("q_j", q_j, (B, NP, 4)), ("t_j", t_j, (B, NP, 3)), ("edge", edge, (N, NP, T)),
            ("msg_mask", msg_mask, (B, N, NP))):
        _check(name, x, shape, dev)
    return _run(w, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask, bf16)


def _project(x: torch.Tensor, w_t: torch.Tensor, bf16) -> torch.Tensor:
    """x @ w_t; in bf16 mode one bf16 pass (operands rounded, fp32 sums),
    which is what XLA's DEFAULT precision does on the TPU. fp32 and high
    run IEEE fp32 (TF32 off): high is what XLA's ``Precision.HIGH`` gives
    on the CPU, where the JAX package's tests run, not the TPU's 3-pass."""
    if mode_of(bf16) == "bf16":
        return torch.matmul(_bf16_round(x), _bf16_round(w_t))
    return torch.matmul(x, w_t)


@dataclass
class LayerContext:
    """One layer's inputs that stay fixed over a trajectory, checked once:
    the packed weights, the neighbour projection ``wj_t`` = W1[H:2H].T
    [H, T], the pocket's a_j [B, P, T] and frames, the edge terms [N, NP, T]
    (zero toward the pocket) and the message mask [B, N, NP]. Calling it
    with the peptide state and the peptide a_j runs the layer; only those
    per-step tensors are checked then."""

    w: PackedLayer
    wj_t: torch.Tensor
    aj_pocket: torch.Tensor
    q_pocket: torch.Tensor
    t_pocket: torch.Tensor
    edge: torch.Tensor
    msg_mask: torch.Tensor
    bf16: bool | str  # False, True or "high" (mode_of)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """Neighbour pre-activation h @ W1[H:2H] (no bias) -> [B, *, T]."""
        return _project(h, self.wj_t, self.bf16)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The device tensors a call reads (a captured step's static
        inputs, refreshed in place for another batch)."""
        return (self.w.buf, self.wj_t, self.aj_pocket, self.q_pocket, self.t_pocket, self.edge,
                self.msg_mask)

    def inputs(self, h, q, t, tors, aj_pep):
        """The kernel's ten inputs for this peptide state (peptide
        neighbours first, then the pocket)."""
        return (self.w, h, q, t, tors, torch.cat((aj_pep, self.aj_pocket), dim=1),
                torch.cat((q, self.q_pocket), dim=1), torch.cat((t, self.t_pocket), dim=1),
                self.edge, self.msg_mask)

    def __call__(self, h, q, t, tors, aj_pep):
        B, N, _ = self.msg_mask.shape
        dev = self.edge.device
        for name, x, shape in (
                ("h", h, (B, N, self.w.H)), ("q_i", q, (B, N, 4)), ("t_i", t, (B, N, 3)),
                ("tors", tors, (B, N, N_TORSIONS, 2)), ("a_j", aj_pep, (B, N, T))):
            _check(name, x, shape, dev)
        return _run(*self.inputs(h, q, t, tors, aj_pep), bf16=self.bf16)


def layer_context(layer: EGNNLayer, edge_pre, mask, pocket_features,
                  pocket_frames: RigidArray, pocket_mask, bf16=False) -> LayerContext:
    """Pack, project and check one layer's static inputs. ``edge_pre``
    [N, N, T], ``mask`` [B, N], ``pocket_features`` [B, P, H] (the layer's
    input width), ``pocket_mask`` [B, P]; ``bf16`` selects the kernel's
    mode (``mode_of``): True its bf16 mode and one bf16 pass for the
    neighbour projections, ``"high"`` its high mode and fp32 projections."""
    N, P, H = mask.shape[-1], pocket_mask.shape[-1], pocket_features.shape[-1]
    B = mask.shape[0]
    NP = N + P
    with torch.no_grad():
        w = pack_layer_weights(layer, H, NP)
        wj_t = layer.message_mlp[0].weight[:, H:2 * H].T.contiguous()
        ctx = LayerContext(
            w=w, wj_t=wj_t,
            aj_pocket=_project(pocket_features, wj_t, bf16).contiguous(),
            q_pocket=pocket_frames.quats.contiguous(), t_pocket=pocket_frames.trans.contiguous(),
            edge=torch.nn.functional.pad(edge_pre, (0, 0, 0, P)).contiguous(),
            msg_mask=message_mask(mask, pocket_mask).contiguous(), bf16=FLAGS[mode_of(bf16)])
    dev = ctx.edge.device
    _check_weights(ctx.w, dev)
    for name, x, shape in (
            ("wj_t", ctx.wj_t, (H, T)), ("aj_pocket", ctx.aj_pocket, (B, P, T)),
            ("q_pocket", ctx.q_pocket, (B, P, 4)), ("t_pocket", ctx.t_pocket, (B, P, 3)),
            ("edge", ctx.edge, (N, NP, T)), ("msg_mask", ctx.msg_mask, (B, N, NP))):
        _check(name, x, shape, dev)
    return ctx


def layer_inputs(layer: EGNNLayer, frames: RigidArray, torsions, features, edge_pre, mask,
                 pocket_features, pocket_frames: RigidArray, pocket_mask):
    """The kernel's ten inputs from ``egnn_forward``'s arguments, with the
    neighbour projection in fp32 as the JAX package's layer-level kernels
    take it: (packed weights, h, q_i, t_i, tors, a_j, q_j, t_j, edge, msg_mask)."""
    ctx = layer_context(layer, edge_pre, mask, pocket_features, pocket_frames, pocket_mask)
    c = lambda x: x.contiguous()
    with torch.no_grad():
        return ctx.inputs(c(features), c(frames.quats), c(frames.trans), c(torsions),
                          c(ctx.project(features)))
