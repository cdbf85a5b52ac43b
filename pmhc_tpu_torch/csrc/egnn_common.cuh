// Device code of the training neighbour loop (egnn_loop.cu): the
// per-chunk recompute of one query row's neighbours, and the
// online-softmax fold. Its constants, bf16 rounding, geometry record
// layout and quaternion and warp helpers are shared with the fused
// sampler layer (egnn_fused.cu) and the round-1 layer (egnn_pallas.cu).
//
// Layout. One block of HEADS = 256 threads per query row (b, i); thread
// u owns head hidden unit u (head = u / T: 0 attention, 1 rotation,
// 2 torsion, 3 translation) and keeps its row of the folded head matrix
// whm = wheads @ wm2 in registers. Neighbours j go in chunks of CH = 32:
//   build_chunk  hid tile relu(a_i + a_j + edge) [CH][T] and warp 0's
//                geometry records [CH][GEO];
//   head_chunk   act = relu(whm @ hid + extra) [CH][ACT_LD], thread u
//                computing its unit for the chunk, 4 neighbours in flight;
//   lin2_chunk   the 13 head lin2 rows [CH][OUT_LD], warp w rows w, w + 8;
//   fold_chunk   the chunk into the online softmax (warp 0, lane = j).
// The extra terms of the head pre-activations are rank-1 or node terms:
//   att  wad * (-d2) + waq * qdot^2 + ba1'
//   rot  wrq @ (q_j^-1 q_i q_j) + br1'
//   tor  (torsion node term) + bt1'
//   trl  bl1'
//
// bf16 mode (template BF16) rounds the operands of the per-neighbour
// products to bf16: whm and hid, wrq and the local quat, w2 and act. The
// attention's rank-1 terms, the biases, the node terms, geometry,
// softmax and every sum stay fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace pmhc {

constexpr int T = 64;               // hidden width of every MLP
constexpr int HEADS = 4 * T;        // head hidden units = threads per block
constexpr int NTOR = 7;
constexpr int CH = 32;              // neighbours per chunk (= warp size)
constexpr int ACT_LD = HEADS + 1;   // padded row stride of the act tile
constexpr int NOUT = 13;            // lin2 rows: att 1, rot 4, tor 7, trl 1
constexpr int OUT_LD = 16;
constexpr int GEO = 20;             // floats per neighbour geometry record
constexpr int FOLD = 20;            // m, D, GD[4], TA[7], TR[3], CNT

// geometry record: -d2, qdot^2, local quat[4], q_j^-1[4], q_j[4], dx[3], mask
constexpr int G_ND2 = 0, G_QD2 = 1, G_LQ = 2, G_INV = 6, G_QJ = 10, G_DX = 14, G_MASK = 17;
// online-softmax state
constexpr int F_M = 0, F_D = 1, F_GD = 2, F_TA = 6, F_TR = 13, F_CNT = 16;

// The loop weights: whm [HEADS][T]; wad, waq, ba1, br1, bt1, bl1 [T];
// wrq [T][4]; w2 [NOUT][T]; b2 [NOUT].
struct LoopW {
  const float *whm, *wad, *waq, *ba1, *br1, *bt1, *bl1, *wrq, *w2, *b2;
};

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void qconj(const float* a, float* o) {
  o[0] = a[0];
  o[1] = -a[1];
  o[2] = -a[2];
  o[3] = -a[3];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// first lin2 row and row count of each head
__device__ __forceinline__ int head_row0(int head) {
  return head == 0 ? 0 : head == 1 ? 1 : head == 2 ? 5 : 12;
}
__device__ __forceinline__ int head_rows(int head) {
  return head == 1 ? 4 : head == 2 ? 7 : 1;
}

// One thread's head hidden unit: its whm row (registers) and the
// coefficients of its extra term. ``node_term`` is the torsion head's
// node term for this query row (ignored by the other heads).
template <bool BF16>
struct HeadUnit {
  float wreg[T];
  float c0, c1, c2, c3, cb;
  int head;

  __device__ __forceinline__ void load_row(const LoopW& w, int tid) {
    const float4* wr4 = reinterpret_cast<const float4*>(w.whm + tid * T);
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const float4 v = wr4[k];
      wreg[4 * k + 0] = rnd<BF16>(v.x);
      wreg[4 * k + 1] = rnd<BF16>(v.y);
      wreg[4 * k + 2] = rnd<BF16>(v.z);
      wreg[4 * k + 3] = rnd<BF16>(v.w);
    }
  }

  __device__ __forceinline__ void load_coef(const LoopW& w, int tid, float node_term) {
    head = tid / T;  // warp-uniform
    const int uu = tid - head * T;
    c0 = c1 = c2 = c3 = 0.f;
    if (head == 0) {
      c0 = w.wad[uu];
      c1 = w.waq[uu];
      cb = w.ba1[uu];
    } else if (head == 1) {
      c0 = rnd<BF16>(w.wrq[uu * 4 + 0]);
      c1 = rnd<BF16>(w.wrq[uu * 4 + 1]);
      c2 = rnd<BF16>(w.wrq[uu * 4 + 2]);
      c3 = rnd<BF16>(w.wrq[uu * 4 + 3]);
      cb = w.br1[uu];
    } else if (head == 2) {
      cb = node_term + w.bt1[uu];
    } else {
      cb = w.bl1[uu];
    }
  }
};

// (a) The chunk's hid tile (rounded in bf16 mode; rows past nj are zero)
// and, on warp 0, its geometry records. ``ai_s`` [T] and ``node_s``
// (q_i[4], t_i[3]) are this row's. Returns this thread's sum of the
// unrounded relu(pre) over the chunk, for column tid % T.
template <bool BF16>
__device__ __forceinline__ float build_chunk(const float* __restrict__ aj, const float* __restrict__ qj,
                                             const float* __restrict__ tj,
                                             const float* __restrict__ edge,
                                             const float* __restrict__ mask, const float* ai_s,
                                             const float* node_s, float* hid_s, float* geo_s,
                                             int b, int i, int row, int NP, int j0, int nj, int tid) {
  float hid_sum = 0.f;
  // HEADS % T == 0, so each thread always owns column tid % T
  for (int e = tid; e < CH * T; e += HEADS) {
    const int jj = e / T;
    const int k = e - jj * T;
    float v = 0.f;
    if (jj < nj) {
      const int j = j0 + jj;
      const float pre = ai_s[k] + aj[((size_t)b * NP + j) * T + k] + edge[((size_t)i * NP + j) * T + k];
      v = fmaxf(pre, 0.f);
      hid_sum += v;
    }
    hid_s[e] = rnd<BF16>(v);
  }
  if (tid < CH) {
    float* g = geo_s + tid * GEO;
    if (tid < nj) {
      const int j = j0 + tid;
      const float* q_i = node_s;
      const float* t_i = node_s + 4;
      float q_j[4], dx[3];
      for (int c = 0; c < 4; ++c) q_j[c] = qj[((size_t)b * NP + j) * 4 + c];
      for (int c = 0; c < 3; ++c) dx[c] = t_i[c] - tj[((size_t)b * NP + j) * 3 + c];
      const float d2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
      const float qdot = q_i[0] * q_j[0] + q_i[1] * q_j[1] + q_i[2] * q_j[2] + q_i[3] * q_j[3];
      // zero-quat guard: padded frames may carry all-zero quats
      const float n2 = fmaxf(q_j[0] * q_j[0] + q_j[1] * q_j[1] + q_j[2] * q_j[2] + q_j[3] * q_j[3],
                             1e-30f);
      const float inv[4] = {q_j[0] / n2, -q_j[1] / n2, -q_j[2] / n2, -q_j[3] / n2};
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
      g[G_MASK] = mask[(size_t)row * NP + j];
    } else {
      for (int c = 0; c < GEO; ++c) g[c] = 0.f;
    }
  }
  return hid_sum;
}

// (b) Unit tid of the four head pre-activations for the chunk, 4
// neighbours at a time: act = relu(whm @ hid + extra), rounded in bf16.
template <bool BF16>
__device__ __forceinline__ void head_chunk(const HeadUnit<BF16>& hu, const float* hid_s,
                                           const float* geo_s, float* act_s, int tid) {
  for (int jj0 = 0; jj0 < CH; jj0 += 4) {
    const float4* h0 = reinterpret_cast<const float4*>(hid_s + (jj0 + 0) * T);
    const float4* h1 = reinterpret_cast<const float4*>(hid_s + (jj0 + 1) * T);
    const float4* h2 = reinterpret_cast<const float4*>(hid_s + (jj0 + 2) * T);
    const float4* h3 = reinterpret_cast<const float4*>(hid_s + (jj0 + 3) * T);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const float4 x0 = h0[k], x1 = h1[k], x2 = h2[k], x3 = h3[k];
      const float w0 = hu.wreg[4 * k], w1 = hu.wreg[4 * k + 1], w2 = hu.wreg[4 * k + 2],
                  w3 = hu.wreg[4 * k + 3];
      acc[0] = fmaf(w3, x0.w, fmaf(w2, x0.z, fmaf(w1, x0.y, fmaf(w0, x0.x, acc[0]))));
      acc[1] = fmaf(w3, x1.w, fmaf(w2, x1.z, fmaf(w1, x1.y, fmaf(w0, x1.x, acc[1]))));
      acc[2] = fmaf(w3, x2.w, fmaf(w2, x2.z, fmaf(w1, x2.y, fmaf(w0, x2.x, acc[2]))));
      acc[3] = fmaf(w3, x3.w, fmaf(w2, x3.z, fmaf(w1, x3.y, fmaf(w0, x3.x, acc[3]))));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* g = geo_s + (jj0 + q) * GEO;
      float extra;
      if (hu.head == 0) {
        extra = hu.c0 * g[G_ND2] + hu.c1 * g[G_QD2] + hu.cb;
      } else if (hu.head == 1) {
        extra = hu.c0 * rnd<BF16>(g[G_LQ]) + hu.c1 * rnd<BF16>(g[G_LQ + 1]) +
                hu.c2 * rnd<BF16>(g[G_LQ + 2]) + hu.c3 * rnd<BF16>(g[G_LQ + 3]) + hu.cb;
      } else {
        extra = hu.cb;
      }
      act_s[(jj0 + q) * ACT_LD + tid] = rnd<BF16>(fmaxf(acc[q] + extra, 0.f));
    }
  }
}

// (c) Block-diagonal lin2: row o reads its head's 64 units; lane = neighbour.
template <bool BF16>
__device__ __forceinline__ void lin2_chunk(const LoopW& w, const float* act_s, float* out_s,
                                           int warp, int lane) {
  for (int o = warp; o < NOUT; o += HEADS / 32) {
    const int sec = (o == 0) ? 0 : (o < 5) ? 1 : (o < 12) ? 2 : 3;
    const float* wrow = w.w2 + o * T;
    const float* arow = act_s + lane * ACT_LD + sec * T;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < T; ++k) acc = fmaf(rnd<BF16>(__ldg(wrow + k)), arow[k], acc);
    out_s[lane * OUT_LD + o] = acc + w.b2[o];
  }
}

// (d) Fold the chunk into the online softmax (warp 0, lane = neighbour):
// logit - (1 - mask) * 1e9 against a running max that starts at -1e30.
__device__ __forceinline__ void fold_chunk(const float* geo_s, const float* out_s, float* fold_s,
                                           int lane, int nj) {
  const float* g = geo_s + lane * GEO;
  const float* ov = out_s + lane * OUT_LD;
  const bool valid = lane < nj;
  const float mk = g[G_MASK];
  const float logit = valid ? ov[0] - (1.f - mk) * 1e9f : -INFINITY;
  const float m_run = fold_s[F_M];
  const float m_new = fmaxf(m_run, warp_max(logit));
  const float r = expf(m_run - m_new);
  const float l = valid ? expf(logit - m_new) : 0.f;
  // sigmoid output used UNNORMALIZED: gdelta = q_j (x) (delta (x) q_j^-1)
  float dl[4], t1[4], gdl[4];
  for (int c = 0; c < 4; ++c) dl[c] = 1.f / (1.f + expf(-ov[1 + c]));
  qmul(dl, g + G_INV, t1);
  qmul(g + G_QJ, t1, gdl);
  // every lane holds the same reduced values; lane 0 stores them
  float upd[F_CNT + 1];
  upd[F_M] = m_new;
  upd[F_D] = fold_s[F_D] * r + warp_sum(l);
  for (int c = 0; c < 4; ++c) upd[F_GD + c] = fold_s[F_GD + c] * r + warp_sum(l * gdl[c]);
  for (int k = 0; k < NTOR; ++k) upd[F_TA + k] = fold_s[F_TA + k] * r + warp_sum(l * ov[5 + k]);
  for (int c = 0; c < 3; ++c)
    upd[F_TR + c] = fold_s[F_TR + c] * r + warp_sum(l * ov[12] * g[G_DX + c]);
  upd[F_CNT] = fold_s[F_CNT] + warp_sum(mk);
  __syncwarp();
  if (lane == 0) {
    for (int c = 0; c <= F_CNT; ++c) fold_s[c] = upd[c];
  }
}

}  // namespace pmhc
