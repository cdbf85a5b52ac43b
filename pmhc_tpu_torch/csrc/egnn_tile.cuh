// The neighbour-tile device code of the fused sampler layer (egnn_fused.cu,
// TPU kernels #1/#2) and of the training loop's forward (egnn_loop.cu,
// #4/#5): one persistent block of WARPS = 12 warps per SM walks a
// contiguous run of query rows (b, i), each row's NP neighbours in tiles of
// TILE = 96, folded into the row's online-softmax state. What a kernel adds
// around it: its node inputs, and what it does with a finished row.
//
// Per (row, tile), between barriers:
//   build_tile     the hid tile relu(a_i + a_j + edge), rounded to bf16 in
//                  bf16 mode, split into bf16 hi and lo tiles in high mode,
//                  rows past the tile's neighbours zero; each
//                  warp's partial sums of HID (unrounded, over the tile's
//                  neighbours); the geometry records, one thread per
//                  neighbour;
//   prefetch_tile  (after the build's barrier) cp.async of the next
//                  (row, tile)'s edge and mask rows and, when its batch
//                  element or tile differs, its a_j, q_j and t_j: 16-byte
//                  copies where a tensor starts 16-byte aligned, else 4-byte
//                  copies; the kernel adds its node inputs and commits;
//   tile_product   12 warp tasks (32-neighbour block, head), the heads
//                  rotated over the SM's four sub-partitions, whose
//                  epilogues differ: act = relu(whm @ hid + extra), then the
//                  head's lin2 rows from the task's own registers;
//                  head_task_bf16 on mma.sync m16n8k16 (the epilogue's C
//                  fragments are the lin2's A fragments), head_task_high
//                  the same with three mma.sync per product, head_task_fp32 in
//                  8 x 8 FFMA register tiles (the lin2 partials through a
//                  shuffle reduce-scatter);
//   fold_tile      warps 0-2, 32 neighbours each: the masked logits'
//                  maximum and the 16 sums (fold_sums) as partials; the
//                  kernel sums HID on warps 3-4 (hid_sum);
//   merge_tile     warp 0: the three partials into the row's running state
//                  (online merge: a row of several tiles merges each).
// stage_weights puts whm, the lin2 rows and the extra-term coefficients in
// shared memory once per block (bf16: as mma B fragments; high: as hi and
// lo B fragments), while the first tile's copies land.
//
// The extra terms of the head pre-activations (egnn_common.cuh's
// geometry records supply their operands):
//   att  wad * (-d2) + waq * qdot^2 + ba1'
//   rot  wrq @ (q_j^-1 q_i q_j) + br1'
//   tor  (torsion node term) + bt1', set per row by the kernel
//   trl  bl1'
// bf16 mode rounds the operands of the per-neighbour products to bf16
// (round to nearest even): whm and hid, wrq and the local quat (rounded
// once, in the geometry record), w2 and act. The attention's rank-1
// terms, the biases, the node terms, geometry, softmax and every sum stay
// fp32. high mode splits the operands of the two tensor-core products,
// whm and hid, w2 and act, into bf16 hi + lo (split_bf16x2) and sums
// hi*hi + hi*lo + lo*hi; the rotation term multiplies wrq and the local
// quat unrounded in fp32 FMA (more exact than a split; the plain version
// does the same).

#pragma once

#include "egnn_common.cuh"
#include "mma_bf16.cuh"

#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace pmhc {

constexpr int MAX_DEVICES = 64;
constexpr int WARPS = 12;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 96;             // neighbours per tile: 3 blocks of 32
constexpr int HB_LD = T / 2 + 4;     // bf16 hid row stride in words (72 bf16): conflict-free A loads
constexpr int HF_LD = T + 4;         // fp32 hid row stride in floats
constexpr int GEO_LD = GEO + 1;      // odd strides: a lane per neighbour hits distinct banks
constexpr int O_LD = NOUT + 4;
constexpr int STAGE_LD = T + 1;      // fp32 whm transpose staging

// The shared memory of the tile loop, in floats (every region 16-byte
// aligned); a kernel's own regions follow from END. high mode keeps the hi
// B fragments, then the lo ones (WHM, W2F), and the hid tile's hi rows,
// then its lo rows (HID).
template <int MODE>
struct TileSmem {
  static constexpr bool BF = MODE == MODE_BF16, HI = MODE == MODE_HIGH;
  static constexpr int WHM = 0;    // bf16: B fragments [4 heads][8 n][4 k][32 lanes] uint2; fp32: whm^T [T][HEADS]
  static constexpr int COEF = WHM + (BF ? HEADS * T / 2 : HEADS * T);   // [5][HEADS] extra-term c0..c3, cb
  static constexpr int W2 = COEF + 5 * HEADS;                            // fp32: lin2 rows [NOUT][T]
  static constexpr int B2 = W2 + (MODE == MODE_FP32 ? NOUT * T : 0);     // [16]
  static constexpr int W2F = B2 + 16;  // bf16: lin2 B fragments [4 heads][4 k][32 lanes] uint2
  static constexpr int AJ = W2F + (BF ? 4 * 4 * 32 * 2 : HI ? 2 * 4 * 4 * 32 * 2 : 0);  // the next tile's inputs (cp.async): a_j [TILE][T]
  static constexpr int ED = AJ + TILE * T;                               // edge [TILE][T]
  static constexpr int QJ = ED + TILE * T;                               // q_j [TILE][4]
  static constexpr int TJ = QJ + TILE * 4;                               // t_j [TILE * 3]
  static constexpr int MK = TJ + TILE * 3;                               // mask [TILE]
  static constexpr int HID = MK + TILE;  // hid tile: bf16 [TILE][HB_LD] words; fp32 [TILE][HF_LD]
  static constexpr int GEOS = HID + TILE * (BF ? HB_LD : HI ? 2 * HB_LD : HF_LD);  // [TILE][GEO_LD]
  static constexpr int OUTS = GEOS + TILE * GEO_LD;                      // lin2 outputs [TILE][O_LD]
  static constexpr int HSP = OUTS + TILE * O_LD;                         // HID partials [WARPS][T]
  static constexpr int FP = HSP + WARPS * T;                             // fold partials [3][FOLD]
  static constexpr int FR = FP + 3 * FOLD;                               // the row's running fold
  static constexpr int END = FR + FOLD;
};

// first lin2 row and row count of each head
__host__ __device__ constexpr int row0_of(int head) { return head == 0 ? 0 : head == 1 ? 1 : head == 2 ? 5 : 12; }
__host__ __device__ constexpr int rows_of(int head) { return head == 1 ? 4 : head == 2 ? 7 : 1; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The extra term of head HEAD for one (neighbour, unit): e = the
// neighbour's operands (pair_operands), c = the unit's coefficients
// c0..c3, cb.
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

// The neighbour's operands of the extra term: att -d2, qdot^2; rot the
// local quat (the geometry record holds it rounded in bf16 mode).
template <int HEAD>
__device__ __forceinline__ void pair_operands(const float* geo, int j, float* e) {
  const float* g = geo + j * GEO_LD;
  if constexpr (HEAD == 0) {
    e[0] = g[G_ND2];
    e[1] = g[G_QD2];
  } else if constexpr (HEAD == 1) {
#pragma unroll
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

// fp32 task: neighbours jb + pg + 4q (q < 8) x units HEAD*T + 4ug + v and
// + 32 + 4ug + v (v < 4) per lane (pg = lane / 8, ug = lane % 8).
template <int HEAD>
__device__ __forceinline__ void head_task_fp32(float* sm, int jb, int lane) {
  using S = TileSmem<MODE_FP32>;
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

// bf16 task: neighbours jb .. jb + 31 (two m16 tiles) x the 64 units of
// HEAD on the tensor cores.
template <int HEAD>
__device__ __forceinline__ void head_task_bf16(float* sm, int jb, int lane) {
  using S = TileSmem<MODE_BF16>;
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
    pair_operands<HEAD>(sm + S::GEOS, j, e[mt][0]);
    pair_operands<HEAD>(sm + S::GEOS, j + 8, e[mt][1]);
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

// high task: head_task_bf16's tiles with every product split, hi*hi +
// hi*lo + lo*hi on the tensor cores. The hid A fragments are loaded per
// k-step (hi and lo, both m-tiles), not held for the whole task: held,
// they would double the bf16 task's 32 registers of A fragments.
template <int HEAD>
__device__ __forceinline__ void head_task_high(float* sm, int jb, int lane) {
  using S = TileSmem<MODE_HIGH>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NE = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 1;
  const int g = lane >> 2, c = lane & 3;
  const uint32_t* hh = reinterpret_cast<const uint32_t*>(sm + S::HID);
  const uint32_t* hl = hh + TILE * HB_LD;
  const uint2* whh = reinterpret_cast<const uint2*>(sm + S::WHM);
  const uint2* whl = whh + 4 * 8 * 4 * 32;
  const uint2* w2h = reinterpret_cast<const uint2*>(sm + S::W2F) + HEAD * 4 * 32 + lane;
  const uint2* w2l = w2h + 4 * 4 * 32;
  const float* coef = sm + S::COEF;
  float e[2][2][NE];  // [m-tile][row g, g + 8] extra-term operands
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    pair_operands<HEAD>(sm + S::GEOS, jb + 16 * mt + g, e[mt][0]);
    pair_operands<HEAD>(sm + S::GEOS, jb + 16 * mt + g + 8, e[mt][1]);
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
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int j = jb + 16 * mt + g;
        const int at[4] = {j * HB_LD + ks * 8 + c, (j + 8) * HB_LD + ks * 8 + c, j * HB_LD + ks * 8 + 4 + c,
                           (j + 8) * HB_LD + ks * 8 + 4 + c};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[mt][r] = hh[at[r]];
          al[mt][r] = hl[at[r]];
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int f = ((HEAD * 8 + 2 * t + nn) * 4 + ks) * 32 + lane;
        const uint2 bh = whh[f], bl = whl[f];
        const uint32_t b_h[2] = {bh.x, bh.y}, b_l[2] = {bl.x, bl.y};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_split_16816(cc[mt][nn], ah[mt], al[mt], b_h, b_l);
      }
    }
    // epilogue on the C fragments: + extra, relu, split; the two n-tiles
    // are the lin2's A fragments (hi, lo) for k-step t
    uint32_t lh[2][4], ll[2][4];
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
          split_bf16x2(x0, x1, lh[mt][2 * nn + h8], ll[mt][2 * nn + h8]);
        }
      }
    }
    const uint2 vh = w2h[t * 32], vl = w2l[t * 32];
    const uint32_t b2h[2] = {vh.x, vh.y}, b2l[2] = {vl.x, vl.y};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_split_16816(lacc[mt], lh[mt], ll[mt], b2h, b2l);
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

// Two B fragment registers of whm / w2 at wr (elements 0, 1 and 8, 9):
// bf16 rounded (hi), or hi and lo (high; lo at f[lo_at]).
template <int MODE>
__device__ __forceinline__ void stage_frag(uint2* f, int e, int lo_at, const float* wr) {
  if constexpr (MODE == MODE_HIGH) {
    uint32_t h0, l0, h1, l1;
    split_bf16x2(wr[0], wr[1], h0, l0);
    split_bf16x2(wr[8], wr[9], h1, l1);
    f[e] = make_uint2(h0, h1);
    f[lo_at + e] = make_uint2(l0, l1);
  } else {
    f[e] = make_uint2(pack_bf16x2(wr[0], wr[1]), pack_bf16x2(wr[8], wr[9]));
  }
}

// whm, the lin2 rows and b2, and the extra-term coefficients of heads 0,
// 1 and 3, into shared memory (head 2's cb is the kernel's to set per row).
// fp32 transposes whm through the hid tile, which must not be in use.
template <int MODE>
__device__ __forceinline__ void stage_weights(float* sm, const LoopW& w, int tid) {
  using S = TileSmem<MODE>;
  if constexpr (MODE != MODE_FP32) {
    uint2* whf = reinterpret_cast<uint2*>(sm + S::WHM);
#pragma unroll
    for (int e = tid; e < 4 * 8 * 4 * 32; e += THREADS) {
      const int l = e & 31, ks = (e >> 5) & 3, nt = e >> 7;  // nt = head * 8 + n-tile
      stage_frag<MODE>(whf, e, 4 * 8 * 4 * 32, w.whm + (nt * 8 + (l >> 2)) * T + 16 * ks + 2 * (l & 3));
    }
    // the lin2 B fragments of each head, its rows padded to n = 8 with zeros
    uint2* w2f = reinterpret_cast<uint2*>(sm + S::W2F);
    for (int e = tid; e < 4 * 4 * 32; e += THREADS) {
      const int l = e & 31, t = (e >> 5) & 3, hd = e >> 7;
      const int n = l >> 2;
      if (n < rows_of(hd)) {
        stage_frag<MODE>(w2f, e, 4 * 4 * 32, w.w2 + (row0_of(hd) + n) * T + 16 * t + 2 * (l & 3));
      } else {
        w2f[e] = make_uint2(0u, 0u);
        if constexpr (MODE == MODE_HIGH) w2f[4 * 4 * 32 + e] = make_uint2(0u, 0u);
      }
    }
  } else {
    // whm^T, 64 rows at a time through a padded staging tile (the hid
    // tile): coalesced reads, conflict-free transposed writes
    float* stage = sm + S::HID;
    for (int part = 0; part < HEADS / 64; ++part) {
#pragma unroll
      for (int e = tid; e < 64 * T; e += THREADS)
        stage[(e / T) * STAGE_LD + e % T] = w.whm[part * 64 * T + e];
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
      c[0] = w.wad[uu];
      c[1] = w.waq[uu];
      c[4] = w.ba1[uu];
    } else if (hd == 1) {
      for (int r = 0; r < 4; ++r) c[r] = rnd<MODE == MODE_BF16>(w.wrq[uu * 4 + r]);
      c[4] = w.br1[uu];
    } else if (hd == 3) {
      c[4] = w.bl1[uu];
    }
    for (int r = 0; r < 5; ++r) sm[S::COEF + r * HEADS + u] = c[r];
  }
  if constexpr (MODE == MODE_FP32) {
    for (int e = tid; e < NOUT * T; e += THREADS) sm[S::W2 + e] = w.w2[e];
  }
  if (tid < NOUT) sm[S::B2 + tid] = w.b2[tid];
}

// The neighbour inputs of a launch: a_j [B, NP, T], q_j [B, NP, 4], t_j
// [B, NP, 3], edge [N, NP, T], mask [B, N, NP]; whether a_j, q_j and edge
// start 16-byte aligned (their rows then do too).
struct TileSrc {
  const float *aj, *qj, *tj, *edge, *mask;
  int NP;
  bool al_aj, al_qj, al_ed;
};

__device__ __forceinline__ TileSrc tile_src(const float* aj, const float* qj, const float* tj,
                                            const float* edge, const float* mask, int NP) {
  auto al = [](const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return {aj, qj, tj, edge, mask, NP, al(aj), al(qj), al(edge)};
}

// 16 bytes as one copy where the source is 16-byte aligned, else as four
__device__ __forceinline__ void copy16(float* dst, const float* src, bool aligned) {
  if (aligned) {
    cp_async16(dst, src);
  } else {
    for (int k = 0; k < 4; ++k) cp_async4(dst + k, src + k);
  }
}

// cp.async of tile tl of query row (b, i) = row into the raw buffers: its
// edge and mask rows and, with with_bj, its a_j, q_j and t_j rows. The
// caller commits.
template <int MODE>
__device__ __forceinline__ void prefetch_tile(float* sm, const TileSrc& s, int b, int i, int row, int tl,
                                              bool with_bj, int tid) {
  using S = TileSmem<MODE>;
  const int j0 = tl * TILE, nj = min(TILE, s.NP - j0);
  if (with_bj) {
    const float* src = s.aj + ((size_t)b * s.NP + j0) * T;
    for (int c = tid; c < nj * T / 4; c += THREADS) copy16(sm + S::AJ + 4 * c, src + 4 * c, s.al_aj);
    for (int c = tid; c < nj; c += THREADS)
      copy16(sm + S::QJ + 4 * c, s.qj + ((size_t)b * s.NP + j0 + c) * 4, s.al_qj);
    for (int c = tid; c < nj * 3; c += THREADS)
      cp_async4(sm + S::TJ + c, s.tj + ((size_t)b * s.NP + j0) * 3 + c);
  }
  const float* esrc = s.edge + ((size_t)i * s.NP + j0) * T;
  for (int c = tid; c < nj * T / 4; c += THREADS) copy16(sm + S::ED + 4 * c, esrc + 4 * c, s.al_ed);
  for (int c = tid; c < nj; c += THREADS) cp_async4(sm + S::MK + c, s.mask + (size_t)row * s.NP + j0 + c);
}

// The tile's hid rows (nj neighbours; rows past nj zero), each warp's HID
// partials and the geometry records, from the raw buffers and the row's
// a_i [T], q_i [4], t_i [3] in shared memory.
template <int MODE>
__device__ __forceinline__ void build_tile(float* sm, const float* ai, const float* q_i, const float* t_i,
                                           int nj, int tid, int warp, int lane) {
  using S = TileSmem<MODE>;
  const float2 ai2 = *reinterpret_cast<const float2*>(ai + 2 * lane);
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
    if constexpr (MODE == MODE_BF16) {
      reinterpret_cast<uint32_t*>(sm + S::HID)[j * HB_LD + lane] = pack_bf16x2(v0, v1);
    } else if constexpr (MODE == MODE_HIGH) {
      uint32_t* hh = reinterpret_cast<uint32_t*>(sm + S::HID);
      split_bf16x2(v0, v1, hh[j * HB_LD + lane], hh[(TILE + j) * HB_LD + lane]);
    } else {
      *reinterpret_cast<float2*>(sm + S::HID + j * HF_LD + 2 * lane) = float2{v0, v1};
    }
  }
  sm[S::HSP + warp * T + 2 * lane] = hs0;
  sm[S::HSP + warp * T + 2 * lane + 1] = hs1;
  if (tid < TILE) {
    float* g = sm + S::GEOS + tid * GEO_LD;
    if (tid < nj) {
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
        g[G_LQ + c] = rnd<MODE == MODE_BF16>(lq[c]);  // bf16: the rotation term's operand, rounded once
        g[G_INV + c] = inv[c];
        g[G_QJ + c] = q_j[c];
      }
      for (int c = 0; c < 3; ++c) g[G_DX + c] = dx[c];
      g[G_MASK] = sm[S::MK + tid];
    } else {
      for (int c = 0; c < GEO; ++c) g[c] = 0.f;
    }
  }
}

// The 12 warp tasks: warp = (32-neighbour block, head); the heads rotate
// over the SM's four sub-partitions (warp % 4), whose epilogues differ.
template <int MODE>
__device__ __forceinline__ void tile_product(float* sm, int nj, int warp, int lane) {
  const int jb = 32 * (warp >> 2), hd = (warp + (warp >> 2)) & 3;
  if (jb < nj) {
    if constexpr (MODE == MODE_BF16) {
      if (hd == 0) head_task_bf16<0>(sm, jb, lane);
      else if (hd == 1) head_task_bf16<1>(sm, jb, lane);
      else if (hd == 2) head_task_bf16<2>(sm, jb, lane);
      else head_task_bf16<3>(sm, jb, lane);
    } else if constexpr (MODE == MODE_HIGH) {
      if (hd == 0) head_task_high<0>(sm, jb, lane);
      else if (hd == 1) head_task_high<1>(sm, jb, lane);
      else if (hd == 2) head_task_high<2>(sm, jb, lane);
      else head_task_high<3>(sm, jb, lane);
    } else {
      if (hd == 0) head_task_fp32<0>(sm, jb, lane);
      else if (hd == 1) head_task_fp32<1>(sm, jb, lane);
      else if (hd == 2) head_task_fp32<2>(sm, jb, lane);
      else head_task_fp32<3>(sm, jb, lane);
    }
  }
}

// Warps 0-2: neighbours 32 warp .. 32 warp + 31 of the tile folded into a
// partial of the online softmax (logit - (1 - mask) * 1e9; the maximum,
// then D, GD[4], TA[7], TR[3], CNT against it). Rows past nj are left out.
template <int MODE>
__device__ __forceinline__ void fold_tile(float* sm, int nj, int warp, int lane) {
  using S = TileSmem<MODE>;
  const int j = 32 * warp + lane;
  const bool valid = j < nj;
  float* fp = sm + S::FP + warp * FOLD;
  if (32 * warp >= nj) {
    if (lane <= F_CNT) fp[lane] = lane == F_M ? -INFINITY : 0.f;
    return;
  }
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

// s0 plus the warps' partial sums of HID column k
template <int MODE>
__device__ __forceinline__ float hid_sum(const float* sm, float s0, int k) {
  using S = TileSmem<MODE>;
  for (int w8 = 0; w8 < WARPS; ++w8) s0 += sm[S::HSP + w8 * T + k];
  return s0;
}

// Warp 0: the three fold partials merged into the row's running state
// (from m = -1e30 and zero sums at the row's first tile). Returns the
// merged state's entry ``lane`` (lanes <= F_CNT; 0 on the others).
template <int MODE>
__device__ __forceinline__ float merge_tile(float* sm, int lane) {
  using S = TileSmem<MODE>;
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
  return v;
}

// The SM count of the current device, after the kernel's dynamic shared
// memory opt-in, both once per device (cached in sms_of); a CUDA error
// comes back negated.
template <typename K>
int persistent_sms(K kernel, size_t bytes, std::atomic<int>* sms_of) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return -(int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    sms_of[dev].store(sms, std::memory_order_release);
  }
  return sms;
}

}  // namespace pmhc
