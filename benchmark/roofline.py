"""The yardstick for rates: the H100's published peaks, the network's FLOP
count, and each layer kernel's least time at the layer's logical shapes.

A frozen copy of the system's ``tools/flops.py`` (``layer_flops``,
``forward_flops``; a train step is 3 forwards, a sampler step one) and of the
bound arithmetic of its kernel checks, with bytes counted from the layer's
logical shapes: each input read once and each output written once, whatever
implements the kernel, and the weights as the layer's parameters. Shapes: B
rows, N = 16 peptide residues, NP = N + P neighbours (P = 80 pocket
residues), H node features in, O out, T = 64 the MLPs' hidden width, M = 64
the message width. Peaks (NVIDIA's data sheet, H100 SXM, dense, at 700 W):
fp32 67 TFLOP/s on the CUDA cores, bf16 989 TFLOP/s on the tensor cores, HBM
3.35 TB/s. The fast-f32 mode runs each head product as three bf16 passes of
its split operands and the rest in fp32.
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# a whole step's peak by mode, for mfu
PEAK_STEP = {"f32": PEAK_FP32, "bf16": PEAK_BF16, "fast-f32": PEAK_BF16 / 3}
TRANSITION = 64
HEADS = 13  # lin2 outputs of the attention, translation, rotation, torsion heads


def layer_flops(B, N=16, P=80, H=23, T=64, M=64, O=64):
    """MAC-based FLOPs (2 a MAC) of one EGNN layer forward."""
    NP = N + P
    R = B * N * NP
    f = 2 * B * N * H * T + 2 * B * NP * H * T + 2 * R * T * M
    f += 3 * R * T
    f += 2 * R * M * T + 4 * R * T + 2 * R * T * 1
    f += 2 * B * N * (H + M) * T + 2 * B * N * T * O
    f += 2 * R * M * T + 2 * R * T * 1
    f += 2 * R * (M + 4) * T + 2 * R * T * 4 + 3 * 28 * R
    f += 2 * R * M * T + 2 * B * N * 14 * T + 2 * R * T * 7
    f += R * (4 + 4 + 7 + 3 + M)
    return f


def forward_flops(B, inner=64, M=64):
    """Both layers: 23 -> ``inner`` features, then ``inner`` -> 1."""
    return layer_flops(B, H=23, T=TRANSITION, M=M, O=inner) + \
        layer_flops(B, H=inner, T=TRANSITION, M=M, O=1)


def layer_params(H, O, T=64, M=64, E=31):
    """The parameters of one layer's six MLPs."""
    mlp = lambda i, o: i * T + T + T * o + o  # noqa: E731
    return (mlp(H + M, O) + mlp(2 * H + E, M) + mlp(M + 2, 1) + mlp(M, 1) + mlp(M + 4, 4)
            + mlp(M + 14, 7))


def bound_s(split_flops: float, other_flops: float, nbytes: float, mode: str) -> float:
    """The least time of work whose head products take ``split_flops`` and
    the rest ``other_flops``: the larger of bytes over the HBM rate and
    operations over the mode's peaks (fp32: all at fp32; bf16: all at bf16;
    fast-f32: the head products three times at bf16, the rest at fp32)."""
    if mode == "fast-f32":
        t_ops = 3 * split_flops / PEAK_BF16 + other_flops / PEAK_FP32
    else:
        t_ops = (split_flops + other_flops) / (PEAK_BF16 if mode == "bf16" else PEAK_FP32)
    return max(t_ops, nbytes / PEAK_BYTES)


def fused_bound_s(B, H, O, mode, N=16, P=80, T=64, M=64) -> float:
    """One launch of the fused sampling layer (kernel #1): per (b, i, j)
    pair the head lin1 (4 T x T MACs) and lin2 (13 x T) products, the
    rotation term (4 x T), the pre-activation adds (3 T); per row a_i, the
    torsion node term, the feature MLP. Reads h [B,N,H], the frames and
    torsions of rows and neighbours, a_j [B,NP,T], the edge terms [N,NP,T],
    the message mask [B,N,NP] and the layer's weights; writes
    (q, t, torsions, features) per row."""
    NP = N + P
    pairs = B * N * NP
    split = 2 * pairs * (4 * T * T + HEADS * T)
    other = 2 * (pairs * 4 * T + B * N * (T * H + T * 14 + T * H + T * T + O * T)) + pairs * 3 * T
    read = (B * N * (H + 4 + 3 + 14) + B * NP * (T + 4 + 3) + N * NP * T + B * N * NP
            + layer_params(H, O, T, M)) * 4
    written = B * N * (4 + 3 + 14 + O) * 4
    return bound_s(split, other, read + written, mode)


def loop_bound_s(B, H, O, mode, backward: bool, N=16, P=80, T=64, M=64) -> float:
    """One launch of a training loop kernel (#4 forward, #6 backward with
    its reduction). The forward does the fused layer's pair work; the
    backward recomputes it and adds the transposed products (whm outer
    product and its transpose, dW2 and w2^T, 2 x the head products) and the
    rotation term's two. Reads the pre-projected a_i and torsion term
    [B,N,T], the row and neighbour frames, a_j [B,NP,T], the edge terms,
    the mask and the weights; the forward writes its per-row outputs and
    saved statistics, the backward reads those and their cotangents and
    writes a gradient for each input."""
    NP = N + P
    pairs = B * N * NP
    split = pairs * 2 * (4 * T * T + HEADS * T) * (3 if backward else 1)
    other = pairs * ((2 * 4 * T + 3 * T) + (2 * 2 * 4 * T if backward else 0))
    inputs = (B * N * (2 * T + 4 + 3) + B * NP * (T + 4 + 3) + N * NP * T + B * N * NP
              + layer_params(H, O, T, M)) * 4
    outputs = B * N * (1 + 1 + 4 + 7 + 3 + T + 1) * 4
    nbytes = inputs + outputs if not backward else 2 * inputs + 2 * outputs
    return bound_s(split, other, nbytes, mode)


LAYERS = ((23, 64), (64, 1))  # (H, O) of gnn1 and gnn2
