// Fused EGNN layer forward for Hopper (sm_90a): the whole layer of
// pmhc_tpu_torch/models/egnn.py in one kernel, on pre-projected inputs.
//
// Replaces two TPU kernels that compute the same function:
//   pmhc_tpu/ops/egnn_pallas_lane.py::_make_kernel      (egnn_lane_core, f32)
//   pmhc_tpu/ops/egnn_pallas_lane_g8.py::_make_kernel_g8 (egnn_lane8_core, --bf16)
// Neither TPU layout (lane packing, component-major 8-groups, selection
// matmuls, HEADPACK, batch grid) is carried over: this kernel computes
// the layer's contract on the [B, N, C] layout. Its plain PyTorch twin is
// pmhc_tpu_torch/ops/egnn_fused.py::egnn_fused_plain (same folded math).
//
// Function. For each query residue (b, i) and each of NP = N + P
// neighbours j:
//   pre  = a_i + a_j[b, j] + edge[i, j]          a_i = wmi @ h_i + bm1
//   hid  = relu(pre)                              [T = 64]
//   act  = relu(whm @ hid + extra)                [4T = 256] four heads
//          extra: att  wad*(-d2) + waq*qdot^2 + ba1'
//                 rot  wrq @ (q_j^-1 q_i q_j) + br1'
//                 tor  wtt @ tors14_i + bt1'
//                 trl  bl1'
//   out  = per-head lin2 -> logit, rot4, tor7, mtr (13 rows)
// folded with an online softmax (logit - (1 - mask) * 1e9, running max
// from -1e30) into D, GD[4], TA[7], TR[3], CNT, plus the plain sum
// HID = sum_j hid over ALL neighbours. The per-node finalize (feature
// MLP, quat compose + renormalize, sin/cos compose, translation) runs in
// the same block. whm = wheads @ wm2 and wfm2 = wfm @ wm2 are the message
// lin2 folded into its consumers at pack time (ops/egnn_fused.py).
//
// Bound. Per (b, i, j) pair 4T x T MACs (head lin1) + 13 x T (lin2) +
// 4 x T (rotation term): 3.48 GFLOP per launch at B=64, N=16, NP=96, the
// head product 94 % of it, against ~3.1 MB of inputs: bound by
// operations. fp32 on the CUDA cores (67 TFLOP/s): >= 52 us. bf16 on the
// tensor cores (989 TFLOP/s): >= 3.5 us; there the CUDA-core work around
// the products (the hid tile, geometry, the extra terms, relu and
// rounding of 24,576 head units per query row, the fold) sets the time.
//
// Design: one template, two tile products. What it does about the six
// limits of this kernel's first design (a 256-thread block per query row,
// a thread per head unit with its whm row in registers):
// 1. Serial stages: the geometry records and the fold run on three warps
//    (the fold's 16 sums in one 16-shuffle reduce-scatter), the merge of
//    their partials on one warp, a_i, the torsion node term, the feature
//    MLP and the outputs on all threads (4 lanes per output), where one
//    warp built and folded and one thread finalized. The node MLPs run
//    once per group of 8 rows, each weight loaded once into registers.
// 2. A tiled product: warp w owns 32 neighbours x one head (w / 4, with
//    the heads rotated over the SM's four sub-partitions, whose
//    epilogues differ), 12 tasks, one per warp.
//    bf16: mma.sync m16n8k16 (bf16 operands, fp32 sums), 2 m-tiles x 8
//    n-tiles x 4 k-steps on whm B fragments packed in shared memory.
//    fp32: IEEE FMA on the CUDA cores (no TF32), 8 neighbours x 8 units
//    per thread, 64 FMA per 4 float4 shared loads (16 per 4 before).
// 3. No act tile: the lin2 is block-diagonal, so the warp finishes its
//    head's lin2 rows from its own registers. bf16: the epilogue adds the
//    extra term to the C fragments, applies relu and rounds with
//    cvt.rn.bf16x2.f32; two adjacent n8 C fragments are one k16 A
//    fragment of the lin2 mma against the head's w2 rows padded to n=8
//    (FlashAttention-2's register reuse). The head and lin2 products run
//    on the tensor cores; the rotation term's four products (bf16
//    operands, exact in fp32) stay in the epilogue. fp32: the lin2
//    partials over a thread's 8 units go through a 3-step shuffle
//    reduce-scatter that leaves each lane one neighbour's lin2 rows.
// 4. Loads in flight: cp.async prefetches the next tile's a_j, edge,
//    q_j, t_j, mask and the next row group's node inputs while the
//    current tile computes (16-byte copies of a_j, q_j and edge where
//    their tensors start 16-byte aligned, else 4-byte copies).
// 5. No ragged grid tail: one persistent block of 12 warps per SM, each
//    a contiguous run of query rows (8 at B=64: 128 blocks, one wave,
//    where a block per row left 3.88 waves of 264 slots); whm, the lin2
//    rows and the extra-term coefficients are staged once per block.
// 6. a_j, q_j and t_j stay in shared memory while the next row has the
//    same b: loaded once per 8 rows at B=64, where every row re-read them.
// Neighbours go in tiles of 96 (NP=96: one tile a row); rows past NP are
// zero in the hid tile and masked out of the fold, and a row of several
// tiles folds them with the online merge.
//
// Modes (template BF16): fp32 is IEEE fp32 FMA throughout (no TF32).
// bf16 rounds every MLP matmul operand to bf16 (round to nearest even):
// whm and hid, wrq and the local quaternion, w2 and act, the node MLPs'
// operands; every sum stays fp32, and geometry, the attention's rank-1
// terms, biases, softmax and fold stay fp32.
//
// Interface: plain C, loaded with ctypes. The launcher allocates
// nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include "egnn_common.cuh"
#include "mma_bf16.cuh"

#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace pmhc {
namespace {

constexpr int MAX_DEVICES = 64;
constexpr int WARPS = 12;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 96;             // neighbours per tile: 3 blocks of 32
constexpr int HB_LD = T / 2 + 4;     // bf16 hid row stride in words (72 bf16): conflict-free A loads
constexpr int HF_LD = T + 4;         // fp32 hid row stride in floats
constexpr int GEO_LD = GEO + 1;      // odd strides: a lane per neighbour hits distinct banks
constexpr int O_LD = NOUT + 4;
// node inputs: q_i[4] t_i[3] tors14 h_i[H <= T]
constexpr int N_Q = 0, N_T = 4, N_TOR = 7, N_H = 24, NODE = N_H + T;
constexpr int STAGE_LD = T + 1;      // fp32 whm transpose staging
constexpr int RG = 8;                // query rows per node-MLP group

// Offsets of the packed weight buffer; the order must match
// pmhc_tpu_torch/ops/egnn_fused.py::weight_layout.
struct Offsets {
  int wmi, bm1, whm, wad, waq, ba1, br1, bt1, bl1, wrq, wtt, w2, b2;
  int wfh, wfm2, bf1, wf2, bf2, total;
};

__host__ __device__ inline Offsets weight_offsets(int H, int O) {
  Offsets o;
  int p = 0;
  o.wmi = p;  p += T * H;
  o.bm1 = p;  p += T;
  o.whm = p;  p += HEADS * T;
  o.wad = p;  p += T;
  o.waq = p;  p += T;
  o.ba1 = p;  p += T;
  o.br1 = p;  p += T;
  o.bt1 = p;  p += T;
  o.bl1 = p;  p += T;
  o.wrq = p;  p += T * 4;
  o.wtt = p;  p += T * 2 * NTOR;
  o.w2 = p;   p += NOUT * T;
  o.b2 = p;   p += NOUT;
  o.wfh = p;  p += T * H;
  o.wfm2 = p; p += T * T;
  o.bf1 = p;  p += T;
  o.wf2 = p;  p += O * T;
  o.bf2 = p;  p += O;
  o.total = p;
  return o;
}

// Shared memory, in floats (every region 16-byte aligned).
template <bool BF16>
struct Smem {
  static constexpr int WHM = 0;    // bf16: B fragments [4 heads][8 n][4 k][32 lanes] uint2; fp32: whm^T [T][HEADS]
  static constexpr int COEF = WHM + (BF16 ? HEADS * T / 2 : HEADS * T);  // [5][HEADS] extra-term c0..c3, cb
  static constexpr int W2 = COEF + 5 * HEADS;                            // fp32: lin2 rows [NOUT][T]
  static constexpr int B2 = W2 + (BF16 ? 0 : NOUT * T);                  // [16]
  static constexpr int W2F = B2 + 16;  // bf16: lin2 B fragments [4 heads][4 k][32 lanes] uint2
  static constexpr int AJ = W2F + (BF16 ? 4 * 4 * 32 * 2 : 0);  // the next tile's inputs (cp.async): a_j [TILE][T]
  static constexpr int ED = AJ + TILE * T;                               // edge [TILE][T]
  static constexpr int QJ = ED + TILE * T;                               // q_j [TILE][4]
  static constexpr int TJ = QJ + TILE * 4;                               // t_j [TILE * 3]
  static constexpr int MK = TJ + TILE * 3;                               // mask [TILE]
  static constexpr int NR = MK + TILE;                                   // next group's node inputs [RG][NODE]
  static constexpr int HID = NR + RG * NODE;  // hid tile: bf16 [TILE][HB_LD] words; fp32 [TILE][HF_LD]
  static constexpr int GEOS = HID + TILE * (BF16 ? HB_LD : HF_LD);       // [TILE][GEO_LD]
  static constexpr int OUTS = GEOS + TILE * GEO_LD;                      // lin2 outputs [TILE][O_LD]
  static constexpr int HSP = OUTS + TILE * O_LD;                         // HID partials [WARPS][T]
  // the row group's node inputs, a_i, torsion node terms (+ bt1), HID sums
  // and feature MLP hiddens, [RG][NODE] and [RG][T]
  static constexpr int NS = HSP + WARPS * T;
  static constexpr int AI = NS + RG * NODE;
  static constexpr int TN = AI + RG * T;
  static constexpr int HS = TN + RG * T;
  static constexpr int FH = HS + RG * T;
  static constexpr int FP = FH + RG * T;                                 // fold partials [3][FOLD]
  static constexpr int FR = FP + 3 * FOLD;                               // the row's running fold
  static constexpr int TOTAL = FR + FOLD;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

// first lin2 row and row count of each head, as compile-time values for
// the head templates (egnn_common.cuh's head_row0 / head_rows are not)
__host__ __device__ constexpr int row0_of(int head) { return head == 0 ? 0 : head == 1 ? 1 : head == 2 ? 5 : 12; }
__host__ __device__ constexpr int rows_of(int head) { return head == 1 ? 4 : head == 2 ? 7 : 1; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The extra term of head HEAD for one (neighbour, unit): e = the
// neighbour's operands (att: -d2, qdot^2; rot: the local quat, rounded
// in bf16 mode),
// c = the unit's coefficients c0..c3, cb.
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

template <bool BF16, int HEAD>
__device__ __forceinline__ void pair_operands(const float* geo, int j, float* e) {
  const float* g = geo + j * GEO_LD;
  if constexpr (HEAD == 0) {
    e[0] = g[G_ND2];
    e[1] = g[G_QD2];
  } else if constexpr (HEAD == 1) {
    for (int c = 0; c < 4; ++c) e[c] = rnd<BF16>(g[G_LQ + c]);
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

// fp32 task: neighbours jb + pg + 4q (q < 8) x units HEAD*T + 4ug + v and
// + 32 + 4ug + v (v < 4) per lane (pg = lane / 8, ug = lane % 8).
template <int HEAD>
__device__ __forceinline__ void head_task_fp32(float* sm, int jb, int lane) {
  using S = Smem<false>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  const int pg = lane >> 3, ug = lane & 7;
  const float* hrow = sm + S::HID + (jb + pg) * HF_LD;
  const float* wcol = sm + S::WHM + HEAD * T + 4 * ug;
  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[q][v] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < T; k0 += 4) {
    float4 x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = ld4(hrow + 4 * q * HF_LD + k0);
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
  for (int q = 0; q < 8; ++q) pair_operands<false, HEAD>(sm + S::GEOS, jb + pg + 4 * q, e[q]);
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

// bf16 task: neighbours jb .. jb + 31 (two m16 tiles) x the 64 units of
// HEAD on the tensor cores.
template <int HEAD>
__device__ __forceinline__ void head_task_bf16(float* sm, int jb, int lane) {
  using S = Smem<true>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NE = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 1;
  const int g = lane >> 2, c = lane & 3;
  const uint32_t* hid = reinterpret_cast<const uint32_t*>(sm + S::HID);
  const uint2* whf = reinterpret_cast<const uint2*>(sm + S::WHM);
  const uint2* w2f = reinterpret_cast<const uint2*>(sm + S::W2F) + HEAD * 4 * 32 + lane;
  const float* coef = sm + S::COEF;
  uint32_t a[2][4][4];  // [m-tile][k-step] A fragments of hid
  float e[2][2][NE];    // [m-tile][row g, g + 8] extra-term operands
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int j = jb + 16 * mt + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a[mt][ks][0] = hid[j * HB_LD + ks * 8 + c];
      a[mt][ks][1] = hid[(j + 8) * HB_LD + ks * 8 + c];
      a[mt][ks][2] = hid[j * HB_LD + ks * 8 + 4 + c];
      a[mt][ks][3] = hid[(j + 8) * HB_LD + ks * 8 + 4 + c];
    }
    pair_operands<true, HEAD>(sm + S::GEOS, j, e[mt][0]);
    pair_operands<true, HEAD>(sm + S::GEOS, j + 8, e[mt][1]);
  }
  float lacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {  // units 16t .. 16t + 15 of the head: n-tiles 2t, 2t + 1
    float cc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int r = 0; r < 4; ++r) cc[mt][nn][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const uint2 bv = whf[((HEAD * 8 + 2 * t + nn) * 4 + ks) * 32 + lane];
        const uint32_t b[2] = {bv.x, bv.y};
        mma_bf16_16816(cc[0][nn], a[0][ks], b);
        mma_bf16_16816(cc[1][nn], a[1][ks], b);
      }
    }
    // epilogue on the C fragments: + extra, relu, round; the two n-tiles
    // are the lin2's A fragment for k-step t
    uint32_t la[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int u = HEAD * T + 16 * t + 8 * nn + 2 * c;
      float c0[5], c1[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        c0[r] = coef[r * HEADS + u];
        c1[r] = coef[r * HEADS + u + 1];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          const float x0 = fmaxf(cc[mt][nn][2 * h8] + extra_term<HEAD>(e[mt][h8], c0), 0.f);
          const float x1 = fmaxf(cc[mt][nn][2 * h8 + 1] + extra_term<HEAD>(e[mt][h8], c1), 0.f);
          la[mt][2 * nn + h8] = pack_bf16x2(x0, x1);
        }
      }
    }
    const uint2 wv = w2f[t * 32];
    const uint32_t b2[2] = {wv.x, wv.y};
    mma_bf16_16816(lacc[0], la[0], b2);
    mma_bf16_16816(lacc[1], la[1], b2);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int j = jb + 16 * mt + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = 2 * c + r;
      if (n < R) {
        sm[S::OUTS + j * O_LD + R0 + n] = lacc[mt][r] + sm[S::B2 + R0 + n];
        sm[S::OUTS + (j + 8) * O_LD + R0 + n] = lacc[mt][2 + r] + sm[S::B2 + R0 + n];
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
egnn_fused_kernel(const float* __restrict__ w,
                  const float* __restrict__ h,      // [B, N, H]
                  const float* __restrict__ qi,     // [B, N, 4]
                  const float* __restrict__ ti,     // [B, N, 3]
                  const float* __restrict__ tors,   // [B, N, 7, 2]
                  const float* __restrict__ aj,     // [B, NP, T]
                  const float* __restrict__ qj,     // [B, NP, 4]
                  const float* __restrict__ tj,     // [B, NP, 3]
                  const float* __restrict__ edge,   // [N, NP, T]
                  const float* __restrict__ mask,   // [B, N, NP]
                  float* __restrict__ out_q,        // [B, N, 4]
                  float* __restrict__ out_t,        // [B, N, 3]
                  float* __restrict__ out_tors,     // [B, N, 7, 2]
                  float* __restrict__ out_feat,     // [B, N, O]
                  int rows, int per_block, int N, int NP, int H, int O) {
  using S = Smem<BF16>;
  extern __shared__ __align__(16) float smem[];
  float* sm = smem;
  const int row_lo = blockIdx.x * per_block;
  const int row_hi = min(rows, row_lo + per_block);
  if (row_lo >= row_hi) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Offsets off = weight_offsets(H, O);
  const int tiles = (NP + TILE - 1) / TILE;
  const int items = (row_hi - row_lo) * tiles;

  // -- prefetch of one work item (row, tile) into the raw buffers, and of
  // -- the node inputs of the row group it opens --------------------------
  // a_j, q_j and edge rows start 16-byte aligned wherever their tensors do:
  // 16-byte copies then, else 4-byte copies (a view may start anywhere)
  const bool al_aj = (reinterpret_cast<uintptr_t>(aj) & 15) == 0;
  const bool al_qj = (reinterpret_cast<uintptr_t>(qj) & 15) == 0;
  const bool al_ed = (reinterpret_cast<uintptr_t>(edge) & 15) == 0;
  auto copy16 = [](float* dst, const float* src, bool aligned) {
    if (aligned) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < 4; ++k) cp_async4(dst + k, src + k);
    }
  };
  auto prefetch = [&](int it, bool with_bj) {
    const int row = row_lo + it / tiles, tl = it % tiles;
    const int b = row / N, i = row - b * N;
    const int j0 = tl * TILE, nj = min(TILE, NP - j0);
    if (with_bj) {
      const float* src = aj + ((size_t)b * NP + j0) * T;
      for (int c = tid; c < nj * T / 4; c += THREADS) copy16(sm + S::AJ + 4 * c, src + 4 * c, al_aj);
      for (int c = tid; c < nj; c += THREADS)
        copy16(sm + S::QJ + 4 * c, qj + ((size_t)b * NP + j0 + c) * 4, al_qj);
      for (int c = tid; c < nj * 3; c += THREADS)
        cp_async4(sm + S::TJ + c, tj + ((size_t)b * NP + j0) * 3 + c);
    }
    const float* esrc = edge + ((size_t)i * NP + j0) * T;
    for (int c = tid; c < nj * T / 4; c += THREADS) copy16(sm + S::ED + 4 * c, esrc + 4 * c, al_ed);
    for (int c = tid; c < nj; c += THREADS) cp_async4(sm + S::MK + c, mask + (size_t)row * NP + j0 + c);
    if (tl == 0 && (row - row_lo) % RG == 0) {
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
  prefetch(0, true);

  // -- the block's resident weights (while the first tile lands) -------------
  if constexpr (BF16) {
    uint2* whf = reinterpret_cast<uint2*>(sm + S::WHM);
#pragma unroll
    for (int e = tid; e < 4 * 8 * 4 * 32; e += THREADS) {
      const int l = e & 31, ks = (e >> 5) & 3, nt = e >> 7;  // nt = head * 8 + n-tile
      const float* wr = w + off.whm + (nt * 8 + (l >> 2)) * T + 16 * ks + 2 * (l & 3);
      whf[e] = make_uint2(pack_bf16x2(wr[0], wr[1]), pack_bf16x2(wr[8], wr[9]));
    }
    // the lin2 B fragments of each head, its rows padded to n = 8 with zeros
    uint2* w2f = reinterpret_cast<uint2*>(sm + S::W2F);
    for (int e = tid; e < 4 * 4 * 32; e += THREADS) {
      const int l = e & 31, t = (e >> 5) & 3, hd = e >> 7;
      const int n = l >> 2;
      const float* wr = w + off.w2 + (row0_of(hd) + n) * T + 16 * t + 2 * (l & 3);
      w2f[e] = n < rows_of(hd) ? make_uint2(pack_bf16x2(wr[0], wr[1]), pack_bf16x2(wr[8], wr[9]))
                               : make_uint2(0u, 0u);
    }
  } else {
    // whm^T, 64 rows at a time through a padded staging tile (the hid
    // tile, not yet in use): coalesced reads, conflict-free transposed writes
    float* stage = sm + S::HID;
    for (int part = 0; part < HEADS / 64; ++part) {
#pragma unroll
      for (int e = tid; e < 64 * T; e += THREADS)
        stage[(e / T) * STAGE_LD + e % T] = w[off.whm + part * 64 * T + e];
      __syncthreads();
#pragma unroll
      for (int e = tid; e < 64 * T; e += THREADS)
        sm[S::WHM + (e / 64) * HEADS + part * 64 + e % 64] = stage[(e % 64) * STAGE_LD + e / 64];
      __syncthreads();
    }
  }
  for (int u = tid; u < HEADS; u += THREADS) {
    const int hd = u / T, uu = u - hd * T;
    float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (hd == 0) {
      c[0] = w[off.wad + uu];
      c[1] = w[off.waq + uu];
      c[4] = w[off.ba1 + uu];
    } else if (hd == 1) {
      for (int r = 0; r < 4; ++r) c[r] = rnd<BF16>(w[off.wrq + uu * 4 + r]);
      c[4] = w[off.br1 + uu];
    } else if (hd == 3) {
      c[4] = w[off.bl1 + uu];
    }  // head 2's cb is set per row: the torsion node term + bt1
    for (int r = 0; r < 5; ++r) sm[S::COEF + r * HEADS + u] = c[r];
  }
  if constexpr (!BF16) {
    for (int e = tid; e < NOUT * T; e += THREADS) sm[S::W2 + e] = w[off.w2 + e];
  }
  if (tid < NOUT) sm[S::B2 + tid] = w[off.b2 + tid];


  for (int it = 0; it < items; ++it) {
    const int row = row_lo + it / tiles, tl = it % tiles;
    const int b = row / N;
    const int nj = min(TILE, NP - tl * TILE);
    const int r = (row - row_lo) % RG;          // the row's place in its group
    const int g0 = row - r;                     // the group's first row
    const int rg = min(RG, row_hi - g0);        // the group's rows
    cp_async_wait_all();
    __syncthreads();  // this item's inputs have landed; the last row's finalize is done

    // -- a new row group: node inputs, a_i and the torsion node terms of all
    // -- its rows, each weight loaded once into registers -------------------
    if (tl == 0 && r == 0) {
      const float* nr = sm + S::NR;
      for (int e = tid; e < rg * NODE; e += THREADS) sm[S::NS + e] = nr[e];
      for (int e = tid; e < rg * T; e += THREADS) sm[S::HS + e] = 0.f;
      if (tid < 4 * T) {  // a_i = wmi @ h_i + bm1: 4 lanes per unit
        const int o = tid >> 2, q = tid & 3;
        float wr[T / 4];
#pragma unroll
        for (int kk = 0; kk < T / 4; ++kk)
          wr[kk] = q + 4 * kk < H ? rnd<BF16>(__ldg(w + off.wmi + o * H + q + 4 * kk)) : 0.f;
        const float bias = __ldg(w + off.bm1 + o);
        float acc[RG] = {};  // the group's rows side by side (rows past rg are not stored)
#pragma unroll
        for (int kk = 0; kk < T / 4; ++kk)
          if (q + 4 * kk < H)
#pragma unroll
            for (int rr = 0; rr < RG; ++rr)
              acc[rr] = fmaf(wr[kk], rnd<BF16>(nr[rr * NODE + N_H + q + 4 * kk]), acc[rr]);
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if (q == 0 && rr < rg) sm[S::AI + rr * T + o] = a + bias;
        }
      } else {  // the torsion head's node term wtt @ tors14 + bt1: 2 lanes per unit
        const int o = (tid - 4 * T) >> 1, q = tid & 1;
        float wr[NTOR];
#pragma unroll
        for (int kk = 0; kk < NTOR; ++kk) wr[kk] = rnd<BF16>(__ldg(w + off.wtt + o * 2 * NTOR + q + 2 * kk));
        const float bias = __ldg(w + off.bt1 + o);
        float acc[RG] = {};
#pragma unroll
        for (int kk = 0; kk < NTOR; ++kk)
#pragma unroll
          for (int rr = 0; rr < RG; ++rr)
            acc[rr] = fmaf(wr[kk], rnd<BF16>(nr[rr * NODE + N_TOR + q + 2 * kk]), acc[rr]);
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
          if (q == 0 && rr < rg) sm[S::TN + rr * T + o] = a + bias;
        }
      }
      __syncthreads();
    }
    const float* ns = sm + S::NS + r * NODE;

    // -- build: hid tile, HID partials, geometry records; a new row's state --
    {
      const float2 ai2 = *reinterpret_cast<const float2*>(sm + S::AI + r * T + 2 * lane);
      float hs0 = 0.f, hs1 = 0.f;
      for (int j = warp; j < TILE; j += WARPS) {
        float v0 = 0.f, v1 = 0.f;
        if (j < nj) {
          const float2 x = *reinterpret_cast<const float2*>(sm + S::AJ + j * T + 2 * lane);
          const float2 y = *reinterpret_cast<const float2*>(sm + S::ED + j * T + 2 * lane);
          v0 = fmaxf(ai2.x + x.x + y.x, 0.f);
          v1 = fmaxf(ai2.y + x.y + y.y, 0.f);
          hs0 += v0;
          hs1 += v1;
        }
        if constexpr (BF16) {
          reinterpret_cast<uint32_t*>(sm + S::HID)[j * HB_LD + lane] = pack_bf16x2(v0, v1);
        } else {
          *reinterpret_cast<float2*>(sm + S::HID + j * HF_LD + 2 * lane) = float2{v0, v1};
        }
      }
      sm[S::HSP + warp * T + 2 * lane] = hs0;
      sm[S::HSP + warp * T + 2 * lane + 1] = hs1;
      if (tid < TILE) {
        float* g = sm + S::GEOS + tid * GEO_LD;
        if (tid < nj) {
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
          const float rn2 = 1.f / n2;  // one division: the chain sets the build's time
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
      } else if (tl == 0 && tid >= 128 && tid < 128 + T) {  // the torsion head's extra term
        sm[S::COEF + 4 * HEADS + 2 * T + tid - 128] = sm[S::TN + r * T + tid - 128];
      } else if (tl == 0 && tid >= 192 && tid < 192 + FOLD) {  // the running fold
        sm[S::FR + tid - 192] = (tid - 192 == F_M) ? -1e30f : 0.f;
      }
    }
    __syncthreads();  // hid, geometry ready; the raw buffers are free

    if (it + 1 < items) {
      const int nrow = row_lo + (it + 1) / tiles, ntl = (it + 1) % tiles;
      prefetch(it + 1, nrow / N != b || ntl != tl);
    }

    // -- tile product: warp = (32-neighbour block, head); the heads rotate
    // -- over the SM's four sub-partitions (warp % 4), whose epilogues differ --
    {
      const int jb = 32 * (warp >> 2), hd = (warp + (warp >> 2)) & 3;
      if (jb < nj) {
        if constexpr (BF16) {
          if (hd == 0) head_task_bf16<0>(sm, jb, lane);
          else if (hd == 1) head_task_bf16<1>(sm, jb, lane);
          else if (hd == 2) head_task_bf16<2>(sm, jb, lane);
          else head_task_bf16<3>(sm, jb, lane);
        } else {
          if (hd == 0) head_task_fp32<0>(sm, jb, lane);
          else if (hd == 1) head_task_fp32<1>(sm, jb, lane);
          else if (hd == 2) head_task_fp32<2>(sm, jb, lane);
          else head_task_fp32<3>(sm, jb, lane);
        }
      }
    }
    __syncthreads();  // lin2 outputs ready

    // -- fold: warps 0-2 fold 32 neighbours each; warps 3-4 sum HID --------
    if (warp < 3) {
      const int j = 32 * warp + lane;
      const bool valid = j < nj;
      float* fp = sm + S::FP + warp * FOLD;
      if (32 * warp >= nj) {
        if (lane <= F_CNT) fp[lane] = lane == F_M ? -INFINITY : 0.f;
      } else {
        const float* g = sm + S::GEOS + j * GEO_LD;
        const float* ov = sm + S::OUTS + j * O_LD;
        const float mk = valid ? g[G_MASK] : 0.f;
        const float logit = valid ? ov[0] - (1.f - mk) * 1e9f : -INFINITY;
        const float m = warp_max(logit);
        const float l = valid ? expf(logit - m) : 0.f;
        // sigmoid output used UNNORMALIZED: gdelta = q_j (x) (delta (x) q_j^-1)
        float dl[4], t1[4], gdl[4], inv[4], qv[4];
        for (int c = 0; c < 4; ++c) {
          dl[c] = 1.f / (1.f + expf(-(valid ? ov[1 + c] : 0.f)));
          inv[c] = valid ? g[G_INV + c] : 0.f;
          qv[c] = valid ? g[G_QJ + c] : 0.f;
        }
        qmul(dl, inv, t1);
        qmul(qv, t1, gdl);
        float v[16];  // the fold's 16 sums, in F_D .. F_CNT order
        v[F_D - 1] = l;
        for (int c = 0; c < 4; ++c) v[F_GD - 1 + c] = l * gdl[c];
        for (int k = 0; k < NTOR; ++k) v[F_TA - 1 + k] = valid ? l * ov[5 + k] : 0.f;
        for (int c = 0; c < 3; ++c) v[F_TR - 1 + c] = valid ? l * ov[12] * g[G_DX + c] : 0.f;
        v[F_CNT - 1] = mk;
        const float sum = fold_sums(v, lane);
        if (lane == 0) fp[F_M] = m;
        if (!(lane & 1)) fp[1 + ((lane >> 1) & 15)] = sum;
      }
    } else if (warp < 5) {
      const int k = tid - 96;
      if (k < T) {
        float s = sm[S::HS + r * T + k];
        for (int w8 = 0; w8 < WARPS; ++w8) s += sm[S::HSP + w8 * T + k];
        sm[S::HS + r * T + k] = s;
      }
    }
    __syncthreads();

    // -- warp 0: merge the three partials into the row's running state;
    // -- after the row's last tile, its geometry outputs ----------------------
    if (warp == 0) {
      float* fr = sm + S::FR;
      float v = 0.f;
      if (lane <= F_CNT) {
        const float* fp = sm + S::FP;
        const float m_run = fr[F_M];
        const float m_new = fmaxf(fmaxf(m_run, fp[F_M]), fmaxf(fp[FOLD + F_M], fp[2 * FOLD + F_M]));
        if (lane == F_M) {
          v = m_new;
        } else if (lane == F_CNT) {
          v = fr[F_CNT] + fp[F_CNT] + fp[FOLD + F_CNT] + fp[2 * FOLD + F_CNT];
        } else {
          v = fr[lane] * expf(m_run - m_new);
          for (int w3 = 0; w3 < 3; ++w3) v += fp[w3 * FOLD + lane] * expf(fp[w3 * FOLD + F_M] - m_new);
        }
      }
      __syncwarp();
      if (lane <= F_CNT) fr[lane] = v;
      __syncwarp();
      if (tl + 1 == tiles && lane < 1 + 3 + NTOR) {
        const float inv_d = 1.f / fr[F_D];
        if (lane == 0) {
          const float* q_i = ns + N_Q;
          float g4[4];
          if (fr[F_CNT] > 0.f) {
            for (int c = 0; c < 4; ++c) g4[c] = fr[F_GD + c] * inv_d;
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
          out_t[(size_t)row * 3 + c] = ns[N_T + c] + fr[F_TR + c] * inv_d;
        } else {
          const int k = lane - 4;
          const float da = fr[F_TA + k] * inv_d;
          const float sn = sinf(da), co = cosf(da);
          const float st = ns[N_TOR + 2 * k], ct = ns[N_TOR + 2 * k + 1];
          out_tors[(size_t)row * 2 * NTOR + 2 * k] = sn * ct + co * st;
          out_tors[(size_t)row * 2 * NTOR + 2 * k + 1] = co * ct - sn * st;
        }
      }
    }
    if (tl + 1 < tiles || r + 1 < rg) continue;

    // -- the group's last row is done: its feature MLPs, each weight loaded
    // -- once into registers for all the group's rows -------------------------
    __syncthreads();
    if (tid < 4 * T) {  // hidden = relu(wfh @ h_i + wfm2 @ HID + bf1): 4 lanes per unit
      const int o = tid >> 2, q = tid & 3;
      float wh[T / 4], wm[T / 4];
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk) {
        const int k = q + 4 * kk;
        wh[kk] = k < H ? rnd<BF16>(__ldg(w + off.wfh + o * H + k)) : 0.f;
        wm[kk] = rnd<BF16>(__ldg(w + off.wfm2 + o * T + k));
      }
      const float bias = __ldg(w + off.bf1 + o);
      float acc[RG] = {};
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk)
        if (q + 4 * kk < H)
#pragma unroll
          for (int rr = 0; rr < RG; ++rr)
            acc[rr] = fmaf(wh[kk], rnd<BF16>(sm[S::NS + rr * NODE + N_H + q + 4 * kk]), acc[rr]);
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr)
          acc[rr] = fmaf(wm[kk], rnd<BF16>(sm[S::HS + rr * T + q + 4 * kk]), acc[rr]);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (q == 0 && rr < rg) sm[S::FH + rr * T + o] = rnd<BF16>(fmaxf(a + bias, 0.f));
      }
    }
    __syncthreads();
    for (int base = 0; base < 4 * O; base += THREADS) {  // feat = wf2 @ hidden + bf2
      const int o = (base + tid) >> 2, q = tid & 3;
      float wr[T / 4];
#pragma unroll
      for (int kk = 0; kk < T / 4; ++kk) wr[kk] = o < O ? rnd<BF16>(__ldg(w + off.wf2 + o * T + q + 4 * kk)) : 0.f;
      const float bias = o < O ? __ldg(w + off.bf2 + o) : 0.f;
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

template <bool BF16>
int launch(const float* w, const float* h, const float* qi, const float* ti, const float* tors,
           const float* aj, const float* qj, const float* tj, const float* edge, const float* mask,
           float* out_q, float* out_t, float* out_tors, float* out_feat,
           int B, int N, int NP, int H, int O, cudaStream_t stream) {
  // the shared-memory opt-in and the SM count, once per device and instantiation
  static std::atomic<int> sms_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    err = cudaFuncSetAttribute(egnn_fused_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem<BF16>::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_release);
  }
  // one block per SM, each a contiguous run of query rows
  int rows = B * N;
  int per_block = (rows + sms - 1) / sms;
  const int grid = (rows + per_block - 1) / per_block;
  void* args[] = {&w, &h, &qi, &ti, &tors, &aj, &qj, &tj, &edge, &mask,
                  &out_q, &out_t, &out_tors, &out_feat, &rows, &per_block, &N, &NP, &H, &O};
  err = cudaLaunchKernel(egnn_fused_kernel<BF16>, dim3(grid), dim3(THREADS), args, Smem<BF16>::BYTES,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pmhc

extern "C" {

// Length in floats of the packed weight buffer for input width H and
// output width O (the Python packer checks its buffer against it).
int egnn_fused_weights_size(int H, int O) { return pmhc::weight_offsets(H, O).total; }

int egnn_fused_launch(const float* w, const float* h, const float* qi, const float* ti,
                      const float* tors, const float* aj, const float* qj, const float* tj,
                      const float* edge, const float* mask, float* out_q, float* out_t,
                      float* out_tors, float* out_feat, int B, int N, int NP, int H, int O,
                      int bf16, void* stream) {
  using namespace pmhc;
  if (H < 1 || H > T || O < 1 || O > HEADS || B < 1 || N < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<true>(w, h, qi, ti, tors, aj, qj, tj, edge, mask, out_q, out_t, out_tors,
                        out_feat, B, N, NP, H, O, s);
  }
  return launch<false>(w, h, qi, ti, tors, aj, qj, tj, edge, mask, out_q, out_t, out_tors,
                       out_feat, B, N, NP, H, O, s);
}

}  // extern "C"
