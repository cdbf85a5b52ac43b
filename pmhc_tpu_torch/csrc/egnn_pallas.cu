// The round-1 fused EGNN layer forward for Hopper (sm_90a): the whole
// layer of pmhc_tpu_torch/models/egnn.py in one kernel, with its six MLPs
// unfolded over a materialised message tile.
//
// Replaces the TPU kernel
//   pmhc_tpu/ops/egnn_pallas.py::_kernel (:84), launched by
//   egnn_forward_pallas (:210, pallas_call at :295)
// without its TPU layout (features on lanes, batch-block grid, padder,
// VMEM cap): this kernel computes its contract on the [B, N, C] layout.
// Its plain PyTorch twin is pmhc_tpu_torch/ops/egnn_pallas.py::
// egnn_pallas_plain, written step for step as _kernel computes.
//
// Contract (what makes it a kernel distinct from egnn_fused.cu, which
// folds the message lin2 into its consumers and streams an online
// softmax): for each query residue (b, i) and all NP = N + P neighbours j
//   hid     = relu(h_i @ mw1[:H] + h_j @ mw1[H:2H] + edge[i, j] + mb1)
//   msg     = hid @ mw2 + mb2                          [NP, M] in shared memory
//   logit   = relu(msg @ aw1[:M] - d2 aw1[M] + qdot^2 aw1[M+1] + ab1) @ aw2 + ab2
//   w       = exact softmax over all NP of logit - (1 - mask) 1e9 (max, exp, sum)
//   feat    = relu(h_i @ fw1[:H] + (sum_j msg) @ fw1[H:] + fb1) @ fw2 + fb2
//             (the plain sum over all NP slots, masked included)
//   delta   = sigmoid(relu(msg @ rw1[:M] + lq @ rw1[M:] + rb1) @ rw2 + rb2)
//             (unnormalised), gd = sum_j w q_j (x) delta (x) q_j^-1
//   tors    = relu(msg @ tw1[:M] + tors14_i @ tw1[M:] + tb1) @ tw2 + tb2
//   trans   = relu(msg @ lw1 + lb1) @ lw2 + lb2
// then gd -> identity where the row has no neighbour, normalised; the
// quaternion update gd (x) q_i normalised again; sin/cos composition of
// the weighted torsion deltas; t_i + sum_j w trans_j (t_i - t_j). The
// mask penalty is the same fp32 subtraction as on the TPU: a fully
// masked row gets (near-)uniform weights. q_j^-1 divides by
// max(|q_j|^2, 1e-30), the port's zero-quaternion guard.
//
// Bound. Per (b, i, j) pair, in multiply-adds: message lin2 T*M = 4,096;
// attention lin1 4,096 (+ 2 x 64 rank-1); rotation lin1 (M+4) T = 4,352;
// torsion lin1 4,096 (its 14-column node part once per row); translation
// lin1 4,096; the four lin2 13 x 64 = 832: ~21.7 K MAC per pair; plus the
// neighbour projection H x T once per (b, j) (1,472 at H = 23, 4,096 at
// H = 64). At B = 64 (98,304 pairs) that is ~4.31 / 4.34 GFLOP per launch
// against ~2.2 / 3.1 MB of inputs and outputs (mostly h_all, the mask and
// the edge terms): bound by operations. The products stay IEEE fp32 FMA
// on the CUDA cores (the TPU kernel runs at Precision.HIGHEST; no TF32 of
// any kind), whose peak is 67 TFLOP/s: >= ~0.064 / 0.065 ms
// (chip_smoke.py::work_of_pallas counts it from the run's shapes).
//
// Design: persistent blocks of 12 warps; five register-tiled products per
// query row. What it does about each limit of the first design (one
// 256-thread block per query row, tile_mm at 1 column x 24 rows a thread):
// 1. The tile product. The four head lin1 products ([NP, 64] x [64, 64]
//    each) run as 12 warp tasks, one per warp: (32 neighbours, head), the
//    heads rotated over the SM's four sub-partitions, each lane holding an
//    8 neighbour x 8 unit fp32 tile (64 FFMA per 4 + 4 float4 shared
//    loads, where tile_mm issued 24 shared and 4 L2 loads per 96). The
//    message lin2 (the same shape, feeding the heads) runs as 12 tasks of
//    32 neighbours x 16 columns, 4 x 4 a lane.
// 2. Weights re-read per query row. One block per SM, each a contiguous
//    run of query rows (8 at B = 64: 128 blocks), sized from the SM count.
//    The five product weights ([64, 64]: mw2, aw1[:M], rw1[:M], tw1[:M],
//    lw1), the 13 lin2 rows, the extra-term coefficients and biases are
//    copied into shared memory once per block by cp.async (~90 KB), where
//    every row read ~150-165 KB from L2. mw1[H:2H] has no room of its own
//    (the block holds 224.6 KB of the 227 KB it may have): it is copied
//    into the message tile, free at that point, when the batch element
//    changes.
// 3. Occupancy and barriers. 384 threads, 5 __syncthreads per row (11
//    before); the next row's edge tile, mask row and the next row group's
//    node inputs (q_i, t_i, torsions, h_i) land by cp.async while the
//    current row computes.
// 4. Head lin2s. Each head's lin2 runs in its lin1 product's epilogue: the
//    relu'd hidden values stay in registers, partial dot products over a
//    lane's 8 units are reduced over the 8 lanes that share a neighbour
//    by a 3-step shuffle reduce-scatter. No hidden tile, no lin2_rows.
// 5. Serial phases. The message sum is taken as column sums in the
//    message product's epilogue. a_i, the torsion node term and the
//    feature MLP run once per group of 8 rows, each weight loaded once
//    into registers for the group; the feature MLP's hidden on 8 warps
//    beside the group's last softmax. The exact softmax runs on 3 warps
//    (each takes the max over all NP, then its 32 neighbours' exp and 16
//    sums in one reduce-scatter); the finalize on 11 lanes.
// 6. The neighbour projection. a_j = h_all[b] @ mw1[H:2H] ([NP, T]) is
//    computed into shared memory when the block's batch element changes:
//    twice per (b, j) at B = 64, where every row recomputed it (16x).
// Rows past NP are zero in the hidden tile, out of the message sum and
// masked out of the softmax; h_all rows (H * 4 bytes) are read 4 bytes at a
// time, and an edge tensor that is not 16-byte aligned goes by 4-byte
// copies.
//
// Interface: plain C, loaded with ctypes. The launcher allocates
// nothing, launches on the caller's stream through cudaLaunchKernel and
// returns cudaGetLastError().

#include "egnn_common.cuh"
#include "mma_bf16.cuh"  // cp.async

#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace pmhc {
namespace {

constexpr int MAX_DEVICES = 64;
constexpr int WARPS = 12;
constexpr int THREADS = 32 * WARPS;
constexpr int M = T;                 // message width
constexpr int MAXNP = 96;            // neighbours per row held in shared memory
constexpr int MAXO = 256;            // widest feature output
constexpr int LD = T + 4;            // hidden and message tile row stride
constexpr int GEO_LD = GEO + 1;      // odd strides: a lane per neighbour hits distinct banks
constexpr int O_LD = NOUT + 4;
// node inputs: q_i[4] t_i[3] tors14 h_i[H <= T]
constexpr int N_Q = 0, N_T = 4, N_TOR = 7, N_H = 24, NODE = N_H + T;
constexpr int RG = 8;                // query rows per node-MLP group

// Offsets of the packed weight buffer: the six MLPs in the TPU kernel's
// order, each lin1.w [in][T], lin1.b [T], lin2.w [T][out], lin2.b [out]
// ([in, out] layout). Must match pmhc_tpu_torch/ops/egnn_pallas.py::weight_layout.
struct Offsets {
  int mw1, mb1, mw2, mb2, aw1, ab1, aw2, ab2, fw1, fb1, fw2, fb2;
  int lw1, lb1, lw2, lb2, rw1, rb1, rw2, rb2, tw1, tb1, tw2, tb2, total;
};

__host__ __device__ inline Offsets weight_offsets(int H, int E, int O) {
  Offsets o;
  int p = 0;
  o.mw1 = p; p += (2 * H + E) * T;
  o.mb1 = p; p += T;
  o.mw2 = p; p += T * M;
  o.mb2 = p; p += M;
  o.aw1 = p; p += (M + 2) * T;
  o.ab1 = p; p += T;
  o.aw2 = p; p += T;
  o.ab2 = p; p += 1;
  o.fw1 = p; p += (H + M) * T;
  o.fb1 = p; p += T;
  o.fw2 = p; p += T * O;
  o.fb2 = p; p += O;
  o.lw1 = p; p += M * T;
  o.lb1 = p; p += T;
  o.lw2 = p; p += T;
  o.lb2 = p; p += 1;
  o.rw1 = p; p += (M + 4) * T;
  o.rb1 = p; p += T;
  o.rw2 = p; p += T * 4;
  o.rb2 = p; p += 4;
  o.tw1 = p; p += (M + 2 * NTOR) * T;
  o.tb1 = p; p += T;
  o.tw2 = p; p += T * NTOR;
  o.tb2 = p; p += NTOR;
  o.total = p;
  return o;
}

// Shared memory, in floats (every region 16-byte aligned).
struct Smem {
  static constexpr int WH = 0;                      // head lin1 [M][HEADS]: att, rot, tor, trl units
  static constexpr int MW2 = WH + M * HEADS;        // message lin2 [T][M]
  static constexpr int COEF = MW2 + T * M;          // [5][HEADS] extra-term c0..c3, cb
  static constexpr int W2 = COEF + 5 * HEADS;       // head lin2 rows [NOUT][T]
  static constexpr int B2 = W2 + NOUT * T;          // [16]
  static constexpr int MB2 = B2 + 16;               // [M]
  static constexpr int AJ = MB2 + M;                // a_j of the batch element [MAXNP][T]
  static constexpr int QJ = AJ + MAXNP * T;         // [MAXNP][4]
  static constexpr int TJ = QJ + MAXNP * 4;         // [MAXNP * 3]
  static constexpr int ED = TJ + MAXNP * 3;         // the next row's edge tile (cp.async) [MAXNP][T]
  static constexpr int MK = ED + MAXNP * T;         // the next row's mask [MAXNP]
  static constexpr int NR = MK + MAXNP;             // the next group's node inputs [RG][NODE]
  static constexpr int HID = NR + RG * NODE;        // h_all, then the message hidden [MAXNP][LD]
  static constexpr int MSG = HID + MAXNP * LD;      // message [MAXNP][LD]
  static constexpr int GEOS = MSG + MAXNP * LD;     // [MAXNP][GEO_LD]
  static constexpr int OUTS = GEOS + MAXNP * GEO_LD;  // head lin2 outputs [MAXNP][O_LD]
  static constexpr int MSP = OUTS + MAXNP * O_LD;   // message column sums per 32 rows [3][M]
  // the row group's node inputs, a_i, torsion node terms (+ tb1), message
  // sums and feature MLP hiddens, [RG][NODE] and [RG][T]
  static constexpr int NS = MSP + 3 * M;
  static constexpr int AI = NS + RG * NODE;
  static constexpr int TN = AI + RG * T;
  static constexpr int MS = TN + RG * T;
  static constexpr int FH = MS + RG * M;
  static constexpr int FP = FH + RG * T;            // softmax partials [3][FOLD]
  static constexpr int TOTAL = FP + 3 * FOLD;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};
static_assert(Smem::BYTES <= 232448, "more shared memory than a Hopper block may have");
static_assert(MAXNP * T / 4 % THREADS == 0 && 4 * T + 4 * 32 == THREADS, "thread mapping");

// first lin2 row and row count of each head, as compile-time values
__host__ __device__ constexpr int row0_of(int head) { return head == 0 ? 0 : head == 1 ? 1 : head == 2 ? 5 : 12; }
__host__ __device__ constexpr int rows_of(int head) { return head == 1 ? 4 : head == 2 ? 7 : 1; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = float4{a, b, c, d};
}
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The extra term of head HEAD for one (neighbour, unit): e = the
// neighbour's operands (att: -d2, qdot^2; rot: the local quat), c = the
// unit's coefficients c0..c3, cb.
template <int HEAD>
__device__ __forceinline__ float extra_term(const float* e, const float* c) {
  if constexpr (HEAD == 0) {
    return c[0] * e[0] + c[1] * e[1] + c[4];
  } else if constexpr (HEAD == 1) {
    return c[0] * e[0] + c[1] * e[1] + c[2] * e[2] + c[3] * e[3] + c[4];
  } else {
    return c[4];
  }
}

template <int HEAD>
__device__ __forceinline__ void pair_operands(const float* geo, int j, float* e) {
  const float* g = geo + j * GEO_LD;
  if constexpr (HEAD == 0) {
    e[0] = g[G_ND2];
    e[1] = g[G_QD2];
  } else if constexpr (HEAD == 1) {
    for (int c = 0; c < 4; ++c) e[c] = g[G_LQ + c];
  }
}

// Sum over the 8 lanes of each lane octet (lane & 7), scattered: lane u
// of the octet returns the sums of v[u * R .. u * R + R).
template <int R>
__device__ __forceinline__ void reduce_scatter8(const float (&v)[8 * R], float (&s)[R], int lane) {
  float a[4 * R], b[2 * R];
  const bool h4 = lane & 4, h2 = lane & 2, h1 = lane & 1;
#pragma unroll
  for (int k = 0; k < 4 * R; ++k) {
    const float keep = h4 ? v[4 * R + k] : v[k], send = h4 ? v[k] : v[4 * R + k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) {
    const float keep = h2 ? a[2 * R + k] : a[k], send = h2 ? a[k] : a[2 * R + k];
    b[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float keep = h1 ? b[R + k] : b[k], send = h1 ? b[k] : b[R + k];
    s[k] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
}

// Warp sums of 16 values in 16 + 8 + 4 + 2 + 1 shuffles (a reduce-scatter):
// lanes 2k and 2k + 1 return the sum of v[k].
__device__ __forceinline__ float fold_sums(const float (&v)[16], int lane) {
  float a[8], b[4], c[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = (h16 ? v[8 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, h16 ? v[k] : v[8 + k], 16);
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = (h8 ? a[4 + k] : a[k]) + __shfl_xor_sync(0xffffffffu, h8 ? a[k] : a[4 + k], 8);
#pragma unroll
  for (int k = 0; k < 2; ++k) c[k] = (h4 ? b[2 + k] : b[k]) + __shfl_xor_sync(0xffffffffu, h4 ? b[k] : b[2 + k], 4);
  const float d = (h2 ? c[1] : c[0]) + __shfl_xor_sync(0xffffffffu, h2 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

// acc[q][v] = sum_{k < K} in[(jb + rg + 8q) * LD + k] * W[k * T + c0 + v]:
// 4 rows x 4 columns of a 32-row block per lane (rg = lane / 4), both
// operands in shared memory. K is a multiple of 4.
__device__ __forceinline__ void prod4x4(const float* in, const float* W, int K, int jb, int c0, int rg,
                                        float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[q][v] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 4) {
    float4 x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = ld4(in + (jb + rg + 8 * q) * LD + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = ld4(W + (k0 + kk) * T + c0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = comp(x[q], kk);
        acc[q][0] = fmaf(wv.x, xv, acc[q][0]);
        acc[q][1] = fmaf(wv.y, xv, acc[q][1]);
        acc[q][2] = fmaf(wv.z, xv, acc[q][2]);
        acc[q][3] = fmaf(wv.w, xv, acc[q][3]);
      }
    }
  }
}

// Head task: the head's lin1 over the message tile for neighbours
// jb + pg + 4q (q < 8) x units HEAD*T + 4ug + v and + 32 + 4ug + v (v < 4)
// per lane (pg = lane / 8, ug = lane % 8); then relu(+ extra) and the
// head's lin2 rows, reduced over the 8 lanes of each neighbour.
template <int HEAD>
__device__ __forceinline__ void head_task(float* sm, int jb, int lane) {
  using S = Smem;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  const int pg = lane >> 3, ug = lane & 7;
  const float* hrow = sm + S::MSG + (jb + pg) * LD;
  const float* wcol = sm + S::WH + HEAD * T + 4 * ug;
  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[q][v] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < M; k0 += 4) {
    float4 x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = ld4(hrow + 4 * q * LD + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wa = ld4(wcol + (k0 + kk) * HEADS), wb = ld4(wcol + (k0 + kk) * HEADS + 32);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float xv = comp(x[q], kk);
        acc[q][0] = fmaf(wa.x, xv, acc[q][0]);
        acc[q][1] = fmaf(wa.y, xv, acc[q][1]);
        acc[q][2] = fmaf(wa.z, xv, acc[q][2]);
        acc[q][3] = fmaf(wa.w, xv, acc[q][3]);
        acc[q][4] = fmaf(wb.x, xv, acc[q][4]);
        acc[q][5] = fmaf(wb.y, xv, acc[q][5]);
        acc[q][6] = fmaf(wb.z, xv, acc[q][6]);
        acc[q][7] = fmaf(wb.w, xv, acc[q][7]);
      }
    }
  }
  // epilogue: act = relu(acc + extra), then the lin2 partials over the 8 units
  constexpr int NE = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 1;
  float e[8][NE];
#pragma unroll
  for (int q = 0; q < 8; ++q) pair_operands<HEAD>(sm + S::GEOS, jb + pg + 4 * q, e[q]);
  const float* coef = sm + S::COEF;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int u = HEAD * T + 4 * ug + (v & 3) + (v >> 2) * 32;
    float c[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) c[r] = coef[r * HEADS + u];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q][v] = fmaxf(acc[q][v] + extra_term<HEAD>(e[q], c), 0.f);
  }
  float part[8 * R];
#pragma unroll
  for (int o = 0; o < R; ++o) {
    const float* w2 = sm + S::W2 + (R0 + o) * T + 4 * ug;
    const float4 wa = ld4(w2), wb = ld4(w2 + 32);
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v) s = fmaf(wv[v], acc[q][v], s);
      part[q * R + o] = s;
    }
  }
  float sum[R];
  reduce_scatter8<R>(part, sum, lane);
  float* out = sm + S::OUTS + (jb + pg + 4 * ug) * O_LD;
#pragma unroll
  for (int o = 0; o < R; ++o) out[R0 + o] = sum[o] + sm[S::B2 + R0 + o];
}

__global__ void __launch_bounds__(THREADS, 1)
egnn_pallas_kernel(const float* __restrict__ w,
                   const float* __restrict__ h,      // [B, N, H]
                   const float* __restrict__ h_all,  // [B, NP, H]
                   const float* __restrict__ qi,     // [B, N, 4]
                   const float* __restrict__ ti,     // [B, N, 3]
                   const float* __restrict__ qj,     // [B, NP, 4]
                   const float* __restrict__ tj,     // [B, NP, 3]
                   const float* __restrict__ tors,   // [B, N, 7, 2]
                   const float* __restrict__ mask,   // [B, N, NP]
                   const float* __restrict__ edge,   // [N, NP, T]
                   float* __restrict__ out_q,        // [B, N, 4]
                   float* __restrict__ out_t,        // [B, N, 3]
                   float* __restrict__ out_tors,     // [B, N, 7, 2]
                   float* __restrict__ out_feat,     // [B, N, O]
                   int rows, int per_block, int N, int NP, int H, int E, int O) {
  using S = Smem;
  extern __shared__ __align__(16) float smem[];
  float* sm = smem;
  const int row_lo = blockIdx.x * per_block;
  const int row_hi = min(rows, row_lo + per_block);
  if (row_lo >= row_hi) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Offsets off = weight_offsets(H, E, O);
  const int HP = (H + 3) & ~3;      // h_all columns, padded to a multiple of 4
  const bool edge16 = (reinterpret_cast<uintptr_t>(edge) & 15) == 0;

  // -- prefetch of one row's edge tile and mask, and of the node inputs of
  // -- the row group it opens ----------------------------------------------
  auto prefetch = [&](int row) {
    const float* esrc = edge + (size_t)(row % N) * NP * T;
    if (edge16) {
      for (int c = tid; c < NP * T / 4; c += THREADS) cp_async16(sm + S::ED + 4 * c, esrc + 4 * c);
    } else {
      for (int c = tid; c < NP * T; c += THREADS) cp_async4(sm + S::ED + c, esrc + c);
    }
    for (int c = tid; c < NP; c += THREADS) cp_async4(sm + S::MK + c, mask + (size_t)row * NP + c);
    if ((row - row_lo) % RG == 0) {
      const int rg = min(RG, row_hi - row);
      for (int e = tid; e < rg * NODE; e += THREADS) {
        const int r = e / NODE, k = e - r * NODE;
        const size_t rr = (size_t)(row + r);
        float* dst = sm + S::NR + e;
        if (k < N_T) cp_async4(dst, qi + rr * 4 + k);
        else if (k < N_TOR) cp_async4(dst, ti + rr * 3 + k - N_T);
        else if (k < N_TOR + 2 * NTOR) cp_async4(dst, tors + rr * 2 * NTOR + k - N_TOR);
        else if (k >= N_H && k < N_H + H) cp_async4(dst, h + rr * H + k - N_H);
      }
    }
    cp_async_commit();
  };
  prefetch(row_lo);

  // -- the block's resident weights, by cp.async (4-byte copies: the heads'
  // -- offsets need not be 16-byte aligned), landing with the first row ----
  for (int e = tid; e < M * HEADS; e += THREADS) {
    const int k = e / HEADS, hd = (e / T) & 3, u = e & (T - 1);
    const int base = hd == 0 ? off.aw1 : hd == 1 ? off.rw1 : hd == 2 ? off.tw1 : off.lw1;
    cp_async4(sm + S::WH + e, w + base + k * T + u);
  }
  for (int e = tid; e < T * M; e += THREADS) cp_async4(sm + S::MW2 + e, w + off.mw2 + e);
  for (int e = tid; e < 5 * HEADS; e += THREADS) {  // extra-term coefficients c0..c3, cb
    const int r = e / HEADS, hd = (e / T) & 3, u = e & (T - 1);
    const float* src = hd == 0 ? (r < 2 ? w + off.aw1 + (M + r) * T + u : r == 4 ? w + off.ab1 + u : nullptr)
                     : hd == 1 ? (r < 4 ? w + off.rw1 + (M + r) * T + u : w + off.rb1 + u)
                     : hd == 3 && r == 4 ? w + off.lb1 + u : nullptr;
    // head 2's cb is set per row: the torsion node term + tb1
    if (src) cp_async4(sm + S::COEF + e, src);
    else sm[S::COEF + e] = 0.f;
  }
  for (int e = tid; e < NOUT * T; e += THREADS) {
    const int o = e / T, u = e - o * T;
    cp_async4(sm + S::W2 + e, o == 0 ? w + off.aw2 + u
                            : o < 5 ? w + off.rw2 + u * 4 + o - 1
                            : o < 12 ? w + off.tw2 + u * NTOR + o - 5
                            : w + off.lw2 + u);
  }
  if (tid < NOUT) {
    cp_async4(sm + S::B2 + tid, tid == 0 ? w + off.ab2 : tid < 5 ? w + off.rb2 + tid - 1
                              : tid < 12 ? w + off.tb2 + tid - 5 : w + off.lb2);
  }
  if (tid < M) cp_async4(sm + S::MB2 + tid, w + off.mb2 + tid);
  cp_async_commit();

  int b_cur = -1;
  for (int row = row_lo; row < row_hi; ++row) {
    const int b = row / N;
    const int r = (row - row_lo) % RG;          // the row's place in its group
    const int g0 = row - r;                     // the group's first row
    const int rg = min(RG, row_hi - g0);        // the group's rows
    const bool new_b = b != b_cur;
    b_cur = b;
    cp_async_wait_all();
    __syncthreads();  // this row's inputs have landed; the last row is done

    // -- a new row group: node inputs, a_i and the torsion node terms of all
    // -- its rows, each weight loaded once into registers -------------------
    if (r == 0) {
      const float* nr = sm + S::NR;
      for (int e = tid; e < rg * NODE; e += THREADS) sm[S::NS + e] = nr[e];
      if (tid < 4 * T) {  // a_i = h_i @ mw1[:H] + mb1: 4 lanes per unit
        const int o = tid >> 2, q = tid & 3;
        float wr[T / 4];
#pragma unroll
        for (int kk = 0; kk < T / 4; ++kk)
          wr[kk] = q + 4 * kk < H ? __ldg(w + off.mw1 + (q + 4 * kk) * T + o) : 0.f;
        const float bias = __ldg(w + off.mb1 + o);
        float acc[RG] = {};  // the group's rows side by side (rows past rg are not stored)
#pragma unroll
        for (int kk = 0; kk < T / 4; ++kk)
          if (q + 4 * kk < H)
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) acc[rr] = fmaf(wr[kk], nr[rr * NODE + N_H + q + 4 * kk], acc[rr]);
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if (q == 0 && rr < rg) sm[S::AI + rr * T + o] = a + bias;
        }
      } else {  // the torsion node term tors14 @ tw1[M:] + tb1: 2 lanes per unit
        const int o = (tid - 4 * T) >> 1, q = tid & 1;
        float wr[NTOR];
#pragma unroll
        for (int kk = 0; kk < NTOR; ++kk) wr[kk] = __ldg(w + off.tw1 + (M + q + 2 * kk) * T + o);
        const float bias = __ldg(w + off.tb1 + o);
        float acc[RG] = {};
#pragma unroll
        for (int kk = 0; kk < NTOR; ++kk)
#pragma unroll
          for (int rr = 0; rr < RG; ++rr) acc[rr] = fmaf(wr[kk], nr[rr * NODE + N_TOR + q + 2 * kk], acc[rr]);
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
          if (q == 0 && rr < rg) sm[S::TN + rr * T + o] = a + bias;
        }
      }
    }
    // -- a new batch element: its h_all (zero-padded; rows of H * 4 bytes,
    // -- copied 4 bytes at a time), q_j and t_j, and mw1[H:2H] (zero rows up
    // -- to HP) in the message tile, which is free until the message lin2 --
    if (new_b) {
      for (int e = tid; e < MAXNP * HP; e += THREADS) {
        const int j = e / HP, k = e - j * HP;
        if (j < NP && k < H) cp_async4(sm + S::HID + j * LD + k, h_all + ((size_t)b * NP + j) * H + k);
        else sm[S::HID + j * LD + k] = 0.f;
      }
      for (int e = tid; e < HP * T; e += THREADS) {
        if (e < H * T) cp_async4(sm + S::MSG + e, w + off.mw1 + H * T + e);
        else sm[S::MSG + e] = 0.f;
      }
      for (int e = tid; e < NP * 4; e += THREADS) cp_async4(sm + S::QJ + e, qj + (size_t)b * NP * 4 + e);
      for (int e = tid; e < NP * 3; e += THREADS) cp_async4(sm + S::TJ + e, tj + (size_t)b * NP * 3 + e);
      cp_async_commit();
      cp_async_wait_all();
    }
    if (r == 0 || new_b) __syncthreads();
    // -- ... and its neighbour projection a_j = h_all[b] @ mw1[H:2H] ---------
    if (new_b) {
      const int jb = 32 * (warp >> 2), c0 = 16 * (warp & 3) + 4 * (lane & 3), rg4 = lane >> 2;
      if (jb < NP) {
        float acc[4][4];
        prod4x4(sm + S::HID, sm + S::MSG, HP, jb, c0, rg4, acc);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st4(sm + S::AJ + (jb + rg4 + 8 * q) * T + c0, acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      }
      __syncthreads();
    }
    const float* ns = sm + S::NS + r * NODE;

    // -- build: hidden tile (rows past NP zero), geometry records ----------
    {
      const float* ai = sm + S::AI + r * T;
#pragma unroll
      for (int it = 0; it < MAXNP * T / 4 / THREADS; ++it) {
        const int e = tid + it * THREADS, j = e >> 4, c = 4 * (e & 15);
        float4 v = {0.f, 0.f, 0.f, 0.f};
        if (j < NP) {
          const float4 a = ld4(ai + c), x = ld4(sm + S::AJ + j * T + c), y = ld4(sm + S::ED + j * T + c);
          v = float4{fmaxf(a.x + x.x + y.x, 0.f), fmaxf(a.y + x.y + y.y, 0.f),
                     fmaxf(a.z + x.z + y.z, 0.f), fmaxf(a.w + x.w + y.w, 0.f)};
        }
        *reinterpret_cast<float4*>(sm + S::HID + j * LD + c) = v;
      }
      if (tid < MAXNP) {
        float* g = sm + S::GEOS + tid * GEO_LD;
        if (tid < NP) {
          const float* q_i = ns + N_Q;
          const float* t_i = ns + N_T;
          float q_j[4], dx[3];
          for (int c = 0; c < 4; ++c) q_j[c] = sm[S::QJ + tid * 4 + c];
          for (int c = 0; c < 3; ++c) dx[c] = t_i[c] - sm[S::TJ + tid * 3 + c];
          const float d2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
          const float qdot = q_i[0] * q_j[0] + q_i[1] * q_j[1] + q_i[2] * q_j[2] + q_i[3] * q_j[3];
          // zero-quat guard: padded frames may carry all-zero quats
          const float n2 = fmaxf(q_j[0] * q_j[0] + q_j[1] * q_j[1] + q_j[2] * q_j[2] + q_j[3] * q_j[3],
                                 1e-30f);
          const float rn2 = 1.f / n2;  // one division: 96 threads' chain sets the build's time
          const float inv[4] = {q_j[0] * rn2, -q_j[1] * rn2, -q_j[2] * rn2, -q_j[3] * rn2};
          float tmp[4], lq[4];
          qmul(q_i, q_j, tmp);
          qmul(inv, tmp, lq);
          g[G_ND2] = -d2;
          g[G_QD2] = qdot * qdot;
          for (int c = 0; c < 4; ++c) {
            g[G_LQ + c] = lq[c];
            g[G_INV + c] = inv[c];
            g[G_QJ + c] = q_j[c];
          }
          for (int c = 0; c < 3; ++c) g[G_DX + c] = dx[c];
          g[G_MASK] = sm[S::MK + tid];
        } else {
          for (int c = 0; c < GEO; ++c) g[c] = 0.f;
        }
      } else if (tid >= 128 && tid < 128 + T) {  // the torsion head's extra term
        sm[S::COEF + 4 * HEADS + 2 * T + tid - 128] = sm[S::TN + r * T + tid - 128];
      }
    }
    __syncthreads();  // hidden tile, geometry ready; the raw buffers are free
    if (row + 1 < row_hi) prefetch(row + 1);

    // -- message lin2: msg = hid @ mw2 + mb2, 32 rows x 16 columns a warp;
    // -- the message sum over all NP slots as column sums ---------------------
    {
      const int rb = warp >> 2, jb = 32 * rb, c0 = 16 * (warp & 3) + 4 * (lane & 3), rg4 = lane >> 2;
      if (jb < NP) {
        float acc[4][4];
        prod4x4(sm + S::HID, sm + S::MW2, T, jb, c0, rg4, acc);
        const float4 bias = ld4(sm + S::MB2 + c0);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = jb + rg4 + 8 * q;
          const float m0 = acc[q][0] + bias.x, m1 = acc[q][1] + bias.y;
          const float m2 = acc[q][2] + bias.z, m3 = acc[q][3] + bias.w;
          st4(sm + S::MSG + j * LD + c0, m0, m1, m2, m3);
          if (j < NP) {
            s[0] += m0;
            s[1] += m1;
            s[2] += m2;
            s[3] += m3;
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          s[v] += __shfl_xor_sync(0xffffffffu, s[v], 4);
          s[v] += __shfl_xor_sync(0xffffffffu, s[v], 8);
          s[v] += __shfl_xor_sync(0xffffffffu, s[v], 16);
        }
        if (lane < 4) st4(sm + S::MSP + rb * M + c0, s[0], s[1], s[2], s[3]);
      }
    }
    __syncthreads();  // message tile ready

    // -- the four heads: warp = (32-neighbour block, head); the heads rotate
    // -- over the SM's four sub-partitions (warp % 4); first the row's message
    // -- sum from the column sums -----------------------------------------------
    if (tid < M) {
      float s = 0.f;
      for (int rb = 0; rb < 3 && 32 * rb < NP; ++rb) s += sm[S::MSP + rb * M + tid];
      sm[S::MS + r * M + tid] = s;
    }
    {
      const int jb = 32 * (warp >> 2), hd = (warp + (warp >> 2)) & 3;
      if (jb < NP) {
        if (hd == 0) head_task<0>(sm, jb, lane);
        else if (hd == 1) head_task<1>(sm, jb, lane);
        else if (hd == 2) head_task<2>(sm, jb, lane);
        else head_task<3>(sm, jb, lane);
      }
    }
    __syncthreads();  // head outputs ready

    // -- exact softmax (warps 0-2): each takes the max over all NP, then its
    // -- 32 neighbours' exp and weighted sums; at the group's last row, warps
    // -- 4-11 the feature MLP's hidden --------------------------------------
    if (warp < 3) {
      float mx = -INFINITY;
#pragma unroll
      for (int s = 0; s < MAXNP / 32; ++s) {
        const int jj = lane + 32 * s;
        if (jj < NP)
          mx = fmaxf(mx, sm[S::OUTS + jj * O_LD] - (1.f - sm[S::GEOS + jj * GEO_LD + G_MASK]) * 1e9f);
      }
      mx = warp_max(mx);
      const int j = 32 * warp + lane;
      const bool valid = j < NP;
      const float* g = sm + S::GEOS + j * GEO_LD;
      const float* ov = sm + S::OUTS + j * O_LD;
      const float mk = valid ? g[G_MASK] : 0.f;
      const float l = valid ? expf((ov[0] - (1.f - mk) * 1e9f) - mx) : 0.f;
      // sigmoid output used UNNORMALIZED: gdelta = q_j (x) (delta (x) q_j^-1)
      float dl[4], t1[4], gdl[4], inv[4], qv[4];
      for (int c = 0; c < 4; ++c) {
        dl[c] = 1.f / (1.f + expf(-(valid ? ov[1 + c] : 0.f)));
        inv[c] = valid ? g[G_INV + c] : 0.f;
        qv[c] = valid ? g[G_QJ + c] : 0.f;
      }
      qmul(dl, inv, t1);
      qmul(qv, t1, gdl);
      float v[16];  // the 16 sums, in F_D .. F_CNT order
      v[F_D - 1] = l;
      for (int c = 0; c < 4; ++c) v[F_GD - 1 + c] = l * gdl[c];
      for (int k = 0; k < NTOR; ++k) v[F_TA - 1 + k] = valid ? l * ov[5 + k] : 0.f;
      for (int c = 0; c < 3; ++c) v[F_TR - 1 + c] = valid ? l * ov[12] * g[G_DX + c] : 0.f;
      v[F_CNT - 1] = mk;
      const float sum = fold_sums(v, lane);
      if (!(lane & 1)) sm[S::FP + warp * FOLD + 1 + ((lane >> 1) & 15)] = sum;
    } else if (r + 1 == rg && warp >= 4) {
      // the group's last row: the feature MLP's hidden for all its rows,
      // relu(h_i @ fw1[:H] + msum @ fw1[H:] + fb1), 4 lanes per unit, each
      // weight loaded once into registers
      const int o = (tid - 4 * 32) >> 2, q = tid & 3;
      float wh[T / 4], wm[T / 4];
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk) {
        const int k = q + 4 * kk;
        wh[kk] = k < H ? __ldg(w + off.fw1 + k * T + o) : 0.f;
        wm[kk] = __ldg(w + off.fw1 + (H + k) * T + o);
      }
      const float bias = __ldg(w + off.fb1 + o);
      float acc[RG] = {};
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk)
        if (q + 4 * kk < H)
#pragma unroll
          for (int rr = 0; rr < RG; ++rr)
            acc[rr] = fmaf(wh[kk], sm[S::NS + rr * NODE + N_H + q + 4 * kk], acc[rr]);
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) acc[rr] = fmaf(wm[kk], sm[S::MS + rr * M + q + 4 * kk], acc[rr]);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (q == 0 && rr < rg) sm[S::FH + rr * T + o] = fmaxf(a + bias, 0.f);
      }
    }
    __syncthreads();  // softmax partials and the group's feature hidden ready

    // -- finalize (11 lanes of warp 0): quaternion, translation, torsions ----
    if (warp == 0 && lane < 1 + 3 + NTOR) {
      const float* fp = sm + S::FP;
      auto tot = [&](int f) { return fp[f] + fp[FOLD + f] + fp[2 * FOLD + f]; };
      const float inv_d = 1.f / tot(F_D);
      if (lane == 0) {
        const float* q_i = ns + N_Q;
        float g4[4];
        if (tot(F_CNT) > 0.f) {
          for (int c = 0; c < 4; ++c) g4[c] = tot(F_GD + c) * inv_d;
        } else {  // no neighbour: identity rotation
          g4[0] = 1.f;
          g4[1] = g4[2] = g4[3] = 0.f;
        }
        float nrm = fmaxf(sqrtf(g4[0] * g4[0] + g4[1] * g4[1] + g4[2] * g4[2] + g4[3] * g4[3]), 1e-12f);
        for (int c = 0; c < 4; ++c) g4[c] /= nrm;
        float uq[4];
        qmul(g4, q_i, uq);
        nrm = fmaxf(sqrtf(uq[0] * uq[0] + uq[1] * uq[1] + uq[2] * uq[2] + uq[3] * uq[3]), 1e-12f);
        for (int c = 0; c < 4; ++c) out_q[(size_t)row * 4 + c] = uq[c] / nrm;
      } else if (lane < 4) {
        const int c = lane - 1;
        out_t[(size_t)row * 3 + c] = ns[N_T + c] + tot(F_TR + c) * inv_d;
      } else {
        const int k = lane - 4;
        const float da = tot(F_TA + k) * inv_d;
        const float sn = sinf(da), co = cosf(da);
        const float st = ns[N_TOR + 2 * k], ct = ns[N_TOR + 2 * k + 1];
        out_tors[(size_t)row * 2 * NTOR + 2 * k] = sn * ct + co * st;
        out_tors[(size_t)row * 2 * NTOR + 2 * k + 1] = co * ct - sn * st;
      }
    }
    if (r + 1 < rg) continue;

    // -- the group's last row: feat = hidden @ fw2 + fb2 for all its rows,
    // -- each weight loaded once into registers -------------------------------
    for (int base = 0; base < 4 * O; base += THREADS) {
      const int o = (base + tid) >> 2, q = tid & 3;
      float wr[T / 4];
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk) wr[kk] = o < O ? __ldg(w + off.fw2 + (q + 4 * kk) * O + o) : 0.f;
      const float bias = o < O ? __ldg(w + off.fb2 + o) : 0.f;
      float acc[RG] = {};
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) acc[rr] = fmaf(wr[kk], sm[S::FH + rr * T + q + 4 * kk], acc[rr]);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (o < O && q == 0 && rr < rg) out_feat[(size_t)(g0 + rr) * O + o] = a + bias;
      }
    }
  }
}

int launch(const float* w, const float* h, const float* h_all, const float* qi, const float* ti,
           const float* qj, const float* tj, const float* tors, const float* mask,
           const float* edge, float* out_q, float* out_t, float* out_tors, float* out_feat,
           int B, int N, int NP, int H, int E, int O, cudaStream_t stream) {
  // the shared-memory opt-in and the SM count, once per device
  static std::atomic<int> sms_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    err = cudaFuncSetAttribute(egnn_pallas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_release);
  }
  // one block per SM, each a contiguous run of query rows
  int rows = B * N;
  int per_block = (rows + sms - 1) / sms;
  const int grid = (rows + per_block - 1) / per_block;
  void* args[] = {&w, &h, &h_all, &qi, &ti, &qj, &tj, &tors, &mask, &edge,
                  &out_q, &out_t, &out_tors, &out_feat, &rows, &per_block, &N, &NP, &H, &E, &O};
  err = cudaLaunchKernel(egnn_pallas_kernel, dim3(grid), dim3(THREADS), args, Smem::BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pmhc

extern "C" {

// Length in floats of the packed weight buffer for input width H, edge
// depth E and output width O (the Python packer checks its buffer against it).
int egnn_pallas_weights_size(int H, int E, int O) { return pmhc::weight_offsets(H, E, O).total; }

int egnn_pallas_launch(const float* w, const float* h, const float* h_all, const float* qi,
                       const float* ti, const float* qj, const float* tj, const float* tors,
                       const float* mask, const float* edge, float* out_q, float* out_t,
                       float* out_tors, float* out_feat, int B, int N, int NP, int H, int E, int O,
                       void* stream) {
  using namespace pmhc;
  if (H < 1 || H > T || E < 0 || O < 1 || O > MAXO || B < 1 || N < 1 || NP < 1 ||
      NP > MAXNP)
    return (int)cudaErrorInvalidValue;
  return launch(w, h, h_all, qi, ti, qj, tj, tors, mask, edge, out_q, out_t, out_tors, out_feat,
                B, N, NP, H, E, O, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
