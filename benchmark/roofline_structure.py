"""The yardstick of the structure network's cells: its forward's FLOP count
and the IPA attention kernel's least time at its logical shapes.

Shapes: B complexes of L = N + P residue rows (N = 16 peptide, P = 80
pocket), ESMFold's published widths (``reference_structure/model.py``'s
``CONFIG``): C_s 384, C_z 128, H 12 heads of C 16, Pq 4 query/key points,
Pv 8 value points, 8 blocks, the angle resnet 128 wide. FLOPs are 2 a
multiply-add of every product (the linears, the attention's contractions
with q, k, v, z and the points, the frames applied to points) and 9 a
query/key point pair (difference, square, sum); normalisations,
activations and the softmax are not counted. The peaks are
``roofline.py``'s (NVIDIA's data sheet, H100 SXM at 700 W).
"""

from __future__ import annotations

from benchmark.reference_structure.model import CONFIG
from benchmark.roofline import PEAK_BYTES, PEAK_FP32

CS, CZ, H = CONFIG["sequence_dim"], CONFIG["pairwise_dim"], CONFIG["num_heads_ipa"]
C, PQ, PV, CR = CONFIG["ipa_dim"], CONFIG["num_qk_points"], CONFIG["num_v_points"], \
    CONFIG["resnet_dim"]
BLOCKS, ANGLES = CONFIG["num_blocks"], CONFIG["num_angles"]
OUT = H * (C + 4 * PV + CZ)  # the attention's output row: o, o_pt, its norms, o_pair


def pair_flops() -> int:
    """The attention's FLOPs a (query row, key row) pair: the pair bias
    z . w_b, q . k, the point distances, a . v, a . v_pts, a . z."""
    return 2 * H * CZ + 2 * H * C + 9 * H * PQ + 2 * H * C + 2 * H * PV * 3 + 2 * H * CZ


def row_flops() -> int:
    """A block's FLOPs a residue row outside the pair terms: the four
    projections, the points into the global frame, o_pt back into frame i,
    linear_out, the transition, the backbone update and the translation's
    rotation."""
    proj = 2 * CS * (H * C + 2 * H * C + H * PQ * 3 + H * (PQ + PV) * 3)
    frames = 18 * (H * PQ + H * (PQ + PV) + H * PV + 1)
    return proj + frames + 2 * OUT * CS + 3 * 2 * CS * CS + 2 * CS * 6


def forward_flops(B: int, L: int = 96) -> int:
    """One forward of the network over B complexes of L rows (a sampler
    step): the embedding of s, ``linear_in``, the blocks and the angle
    resnet (every row)."""
    blocks = BLOCKS * (L * row_flops() + L * L * pair_flops())
    edges = 2 * (CONFIG["node_input_size"] + 1) * CS + 2 * CS * CS
    angles = 2 * 2 * CS * CR + CONFIG["num_resnet_blocks"] * 2 * 2 * CR * CR + 2 * CR * 2 * ANGLES
    return B * (blocks + L * (edges + angles))


def ipa_attention_flops(B: int, L: int = 96) -> int:
    """One launch of the IPA attention kernel: the pair terms and o_pt
    back into frame i."""
    return B * (L * L * pair_flops() + L * 18 * H * PV)


def ipa_attention_bytes(B: int, L: int = 96) -> int:
    """One launch's logical bytes: z [B, L, L, C_z], q, k and v, the query
    points and the key and value points, the frames and the mask read once,
    the output [B, L, OUT] written once, and the pair bias's weights and the
    head weights."""
    per_row = H * C + 2 * H * C + H * PQ * 3 + H * (PQ + PV) * 3 + 9 + 3 + 1 + OUT
    return 4 * (B * L * L * CZ + B * L * per_row + H * CZ + 2 * H)


def ipa_attention_bound_s(B: int, L: int = 96) -> float:
    """The least time of one launch: the larger of its FLOPs at the fp32
    peak and its bytes at the HBM rate."""
    return max(ipa_attention_flops(B, L) / PEAK_FP32, ipa_attention_bytes(B, L) / PEAK_BYTES)
