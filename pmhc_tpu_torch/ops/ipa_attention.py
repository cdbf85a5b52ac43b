"""Invariant point attention's attention (AlphaFold2 Suppl. Algorithm 22,
lines 7-10, as ESMFold computes it): the plain PyTorch version and the
wrapper around the hand-written CUDA kernel of ``csrc/ipa_attention.cu``.

From a block's projections it computes what ESMFold's ``linear_out``
concatenates, per query row i:

- the logits a_hij = sqrt(1/(3 C)) q_hi . k_hj + sqrt(1/3) b_hij
  - 1/2 softplus(gamma_h) sqrt(1/(3 Pq 9/2)) sum_p |T_i q_hip - T_j k_hjp|^2
  + inf (m_i m_j - 1), with the pair bias b_hij = z_ij . w_b,h + b_b,h;
- the softmax over j (fp32, max-subtracted);
- o_hi = sum_j a_hij v_hj [H, C]; o_pt,hip = T_i^-1 sum_j a_hij T_j v_hjp
  [H, Pv, 3] with its norms sqrt(|o_pt|^2 + eps); o_pair,hi = sum_j a_hij
  z_ij [H, C_z];

as [B, L, H (C + 4 Pv + C_z)]: o, the x, y and z of o_pt, its norms,
o_pair, in ESMFold's order. The points come in the global frame (the
frames applied by ``models/structure.py::to_global``), the frames as
rotation matrices and translations to take o_pt back into frame i.

CUDA tensors take the kernel, one launch a call, at the published widths
(H 12, C 16, Pq 4, Pv 8, C_z 128: the kernel's compile-time constants) and
L up to ``MAX_L``; other widths on the card raise. CPU tensors take the
plain version (the composition the kernel replaces) at any width. The
wrapper checks shapes, dtypes, devices and contiguity and raises, with no
fallback. ``LAUNCHES["f32"]`` counts the kernel's launches (one a block of
the structure network: 8 a sampler step on the card).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.nn import functional as F

from pmhc_tpu_torch.ops.egnn_fused import _check, device_ctx

HEADS, HIDDEN, QK_POINTS, V_POINTS, PAIR = 12, 16, 4, 8, 128
MAX_L = 256
OUT = HEADS * (HIDDEN + 4 * V_POINTS + PAIR)

# kernel launches on the main path (a CUDA graph's capture takes its counts
# back and each replay adds them: utils/graphs.py)
LAUNCHES = {"f32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def widths(q, kv, q_pts, kv_pts, z, w_b):
    """(H, C, Pq, Pv, C_z) of the inputs."""
    H = w_b.shape[0]
    C = q.shape[-1] // H
    Pq = q_pts.shape[-2] // H
    Pv = kv_pts.shape[-2] // H - Pq
    return H, C, Pq, Pv, z.shape[-1]


def ipa_attention_plain(q, kv, q_pts, kv_pts, rot, trans, mask, z, w_b, b_b, head_weights,
                        inf: float = 1e5, eps: float = 1e-8) -> torch.Tensor:
    """The attention as ESMFold composes it, on the kernel's inputs."""
    H, C, Pq, Pv, Cz = widths(q, kv, q_pts, kv_pts, z, w_b)
    B, L = mask.shape
    q = q.view(B, L, H, C)
    k, v = kv.view(B, L, H, 2 * C).split(C, dim=-1)
    qp = q_pts.view(B, L, H, Pq, 3)
    kp, vp = kv_pts.view(B, L, H, Pq + Pv, 3).split((Pq, Pv), dim=-2)
    b = F.linear(z, w_b, b_b)                                                # [B, L, L, H]
    a = torch.einsum("bihc,bjhc->bhij", q, k) * math.sqrt(1.0 / (3 * C))
    a = a + math.sqrt(1.0 / 3) * b.permute(0, 3, 1, 2)
    pt = torch.sum((qp[:, :, None] - kp[:, None]) ** 2, -1)                  # [B, L, L, H, Pq]
    hw = F.softplus(head_weights) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
    pt = torch.sum(pt * hw[:, None], -1) * (-0.5)
    a = a + pt.permute(0, 3, 1, 2) + (inf * (mask[:, :, None] * mask[:, None, :] - 1))[:, None]
    a = torch.softmax(a, -1)
    o = torch.einsum("bhij,bjhc->bihc", a, v).reshape(B, L, H * C)
    o_pt = torch.einsum("bhij,bjhpx->bihpx", a, vp)
    o_pt = torch.einsum("biyx,bihpy->bihpx", rot, o_pt - trans[:, :, None, None])
    norm = torch.sqrt(torch.sum(o_pt ** 2, -1) + eps).reshape(B, L, H * Pv)
    o_pt = o_pt.reshape(B, L, H * Pv, 3)
    o_pair = torch.einsum("bhij,bijc->bihc", a, z).reshape(B, L, H * Cz)
    return torch.cat((o, *o_pt.unbind(-1), norm, o_pair), -1)


def _lib():
    from pmhc_tpu_torch.ops import _build

    return bind(_build.load("ipa_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/ipa_attention.cu`` on a loaded
    library (once per library)."""
    if not getattr(lib, "_pmhc_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ipa_attention_launch.argtypes = [ptr] * 12 + [i32, i32, f32, f32, ptr]
        lib.ipa_attention_launch.restype = i32
        lib._pmhc_typed = True
    return lib


def launch(lib, q, kv, q_pts, kv_pts, rot, trans, mask, z, w_b, b_b, head_weights, out,
           inf: float, eps: float, stream: int = 0) -> None:
    """One launch of the kernel on checked inputs, into ``out``."""
    B, L = mask.shape
    err = lib.ipa_attention_launch(
        *(x.data_ptr() for x in (q, kv, q_pts, kv_pts, rot, trans, mask, z, w_b, b_b,
                                 head_weights, out)), B, L, float(inf), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"ipa_attention kernel launch failed: CUDA error {err}")


def check(q, kv, q_pts, kv_pts, rot, trans, mask, z, w_b, b_b, head_weights) -> None:
    """Shapes, dtypes, devices and contiguity, or raise."""
    B, L = mask.shape
    H = w_b.shape[0]
    C = q.shape[-1] // H if H else 0
    Pq = q_pts.shape[-2] // H if H and q_pts.dim() == 4 else 0
    Pv = kv_pts.shape[-2] // H - Pq if H and kv_pts.dim() == 4 else 0
    Cz = z.shape[-1]
    dev = mask.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ipa_attention: unsupported device {dev}")
    if H < 1 or C < 1 or Pq < 1 or Pv < 1:
        raise ValueError(f"ipa_attention: heads {H}, widths q {tuple(q.shape)}, "
                         f"points {tuple(q_pts.shape)} / {tuple(kv_pts.shape)}")
    for name, x, shape in (
            ("q", q, (B, L, H * C)), ("kv", kv, (B, L, 2 * H * C)),
            ("q_pts", q_pts, (B, L, H * Pq, 3)), ("kv_pts", kv_pts, (B, L, H * (Pq + Pv), 3)),
            ("rot", rot, (B, L, 3, 3)), ("trans", trans, (B, L, 3)), ("mask", mask, (B, L)),
            ("z", z, (B, L, L, Cz)), ("w_b", w_b, (H, Cz)), ("b_b", b_b, (H,)),
            ("head_weights", head_weights, (H,))):
        _check(name, x, shape, dev, "ipa_attention")


def ipa_attention(q, kv, q_pts, kv_pts, rot, trans, mask, z, w_b, b_b, head_weights,
                  inf: float = 1e5, eps: float = 1e-8) -> torch.Tensor:
    """The attention's outputs [B, L, H (C + 4 Pv + C_z)] (see the
    module's docstring): ``q`` [B, L, H C] and ``kv`` [B, L, 2 H C] as
    ESMFold's linears give them, ``q_pts`` [B, L, H Pq, 3] and ``kv_pts``
    [B, L, H (Pq + Pv), 3] in the global frame, ``rot`` [B, L, 3, 3] and
    ``trans`` [B, L, 3] the rows' frames, ``mask`` [B, L], ``z`` [B, L,
    L, C_z], ``w_b`` [H, C_z] and ``b_b`` [H] the pair bias's linear,
    ``head_weights`` [H] (before softplus)."""
    args = (q, kv, q_pts, kv_pts, rot, trans, mask, z, w_b, b_b, head_weights)
    check(*args)
    dev = mask.device
    if dev.type == "cpu":
        return ipa_attention_plain(*args, inf=inf, eps=eps)
    B, L = mask.shape
    if widths(q, kv, q_pts, kv_pts, z, w_b) != (HEADS, HIDDEN, QK_POINTS, V_POINTS, PAIR):
        raise ValueError("ipa_attention: the kernel takes the published widths (H, C, Pq, Pv, "
                         f"C_z) = {(HEADS, HIDDEN, QK_POINTS, V_POINTS, PAIR)}, got "
                         f"{widths(q, kv, q_pts, kv_pts, z, w_b)}")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"ipa_attention: {L} rows, the kernel takes 1 to {MAX_L}")
    if z.data_ptr() % 16:
        raise ValueError("ipa_attention: z must start 16-byte aligned")
    out = torch.empty((B, L, OUT), device=dev)
    with device_ctx(dev):
        launch(_lib(), *args, out, inf, eps, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["f32"] += 1
    return out
