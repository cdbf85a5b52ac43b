// The training layer's neighbour loop for Hopper (sm_90a): a forward and
// a backward kernel, each with an fp32 and a bf16 mode.
//
// Replaces four TPU kernels of pmhc_tpu/ops/egnn_pallas_lane_vjp.py:
//   forward   _make_loop_fwd (f32), _make_loop_fwd_g8 (--bf16)
//   backward  _make_loop_bwd (f32), _make_loop_bwd_g8 (--bf16)
// on the [B, N, C] layout, without the TPU layouts (lane packing,
// component-major 8-groups, selection matmuls, HEADPACK, batch grid).
// Plain PyTorch twin: pmhc_tpu_torch/ops/egnn_loop.py::egnn_loop_plain
// (forward) and autograd through it (backward).
//
// Forward. Per query row (b, i), over its NP neighbours, the recompute of
// egnn_common.cuh (a_i and the torsion node term come in pre-projected)
// folded into the online-softmax accumulators m, D, GD[4], TA[7], TR[3],
// CNT and the plain sum HID[T] of relu(pre) over all NP slots. It is
// egnn_fused.cu's neighbour loop without the per-node finalize, which
// stays in torch so autograd carries it. One block of 256 threads per
// row, two blocks per SM.
//
// Backward. Takes the cotangents of D, GD, TA, TR, HID (m and CNT carry
// none) and the forward's final m. Flash-style: each chunk of 32
// neighbours is recomputed (egnn_common.cuh), then
//   B  warp 0, lane = neighbour: e = exp(logit - m); the value-path
//      adjoints (softmax numerators, translation, the rotation chain
//      above the sigmoid) -> d(lin2 outputs) [13];
//   C  thread u: lin2 backward through its unit -> d(pre_heads)[u]
//      (relu-gated), its dW2 row entries, bias / wad / waq / wrq grads,
//      and its dW row of whm (outer product with hid, 64 registers);
//   D  d(hid) = whm^T d(pre_heads) + d(HID), from whm in shared memory
//      (thread = 4 columns x 2 neighbours), relu-gated to d(pre):
//      d(a_i) summed in the block, d(a_j) and d(edge) by atomics;
//   E  per neighbour, sums over the head units: d(local quat) = wrq^T
//      d(rot), wad . d(att), waq . d(att);
//   F  warp 0, lane = neighbour: the quaternion and distance adjoints ->
//      d(q_i), d(t_i) (summed in the lane), d(q_j), d(t_j) by atomics.
// Blocks are persistent (as many as fit on the card, each looping over
// rows), so every weight gradient is summed in registers across all the
// rows of a block, written once per block as a partial, and the partials
// are summed by a second kernel: no atomics and a fixed order for the
// weight gradients. d(a_j), d(q_j), d(t_j) (over the 16 query rows of an
// entry) and d(edge) (over the batch) are summed with fp32 atomics, so
// their last bits vary from run to run.
//
// Bound. Per (b, i, j) pair the forward is ~35 kFLOP (see
// egnn_fused.cu); the backward recomputes it and adds the whm outer
// product and whm^T d(pre_heads) (2 x 256 x 64 MACs) and the lin2 terms:
// ~100 kFLOP, ~10 GFLOP per launch at B=64, N=16, NP=96 against a few MB:
// bound by operations (>= ~0.15 ms at the H100 SXM's published 67 TFLOP/s
// fp32 peak, 700 W). The
// backward holds two 64-float rows per thread (whm for the recompute, its
// gradient), so it runs one block of 256 threads per SM.
//
// bf16 mode: the rounding points of egnn_common.cuh in the recompute;
// in the backward, the operands of the dW2 and dwhm/dwrq outer products,
// of w2^T d(out), of whm^T d(pre_heads) and of wrq^T d(rot) are rounded
// to bf16 (as the g8 TPU backward rounds its matmul operands). Unlike
// the TPU kernels, the attention's rank-1 terms, the biases and the
// torsion node term enter the recompute in fp32 (the TPU's HEADPACK
// rounds them), and the sums over query rows and over the batch are not
// rounded (the TPU's collapse and d(edge) matmuls round their cotangent
// operand). tests/test_torch_egnn_loop.py measures the difference.
//
// Interface: plain C, loaded with ctypes. Launchers allocate nothing,
// launch on the caller's stream and return the CUDA error code.

#include "egnn_common.cuh"

#include <stddef.h>

#include <atomic>

namespace pmhc {
namespace {

constexpr int MAX_DEVICES = 64;

// the flat loop-weight buffer; the order must match
// pmhc_tpu_torch/ops/egnn_loop.py::LOOP_W
constexpr int O_WHM = 0;
constexpr int O_WAD = O_WHM + HEADS * T;
constexpr int O_WAQ = O_WAD + T;
constexpr int O_BA1 = O_WAQ + T;
constexpr int O_BR1 = O_BA1 + T;
constexpr int O_BT1 = O_BR1 + T;
constexpr int O_BL1 = O_BT1 + T;
constexpr int O_WRQ = O_BL1 + T;
constexpr int O_W2 = O_WRQ + T * 4;
constexpr int O_B2 = O_W2 + NOUT * T;
constexpr int W_SIZE = O_B2 + NOUT;

__device__ __forceinline__ LoopW loop_w(const float* w) {
  return {w + O_WHM, w + O_WAD, w + O_WAQ, w + O_BA1, w + O_BR1,
          w + O_BT1, w + O_BL1, w + O_WRQ, w + O_W2, w + O_B2};
}

struct Inputs {
  const float *w, *ai, *tor, *qi, *ti, *aj, *qj, *tj, *edge, *mask;
  int B, N, NP;
};

struct FwdOut {
  float *m, *D, *GD, *TA, *TR, *HID, *CNT;
};

struct BwdIO {
  const float *m, *gD, *gGD, *gTA, *gTR, *gHID;  // forward's m, cotangents
  float *dai, *dtor, *dqi, *dti;                 // per query row
  float *daj, *dqj, *dtj, *dedge;                // summed by atomics (zeroed first)
  float* partial;                                // [gridDim.x][W_SIZE]
};

constexpr size_t FWD_SMEM_FLOATS = CH * T + CH * ACT_LD + CH * GEO + CH * OUT_LD  // chunk tiles
                                   + T + 4 * T + 8 + FOLD;  // a_i, HID partials, node, fold
constexpr size_t FWD_SMEM_BYTES = FWD_SMEM_FLOATS * sizeof(float);

template <bool BF16>
__global__ void __launch_bounds__(HEADS, 2) egnn_loop_fwd_kernel(const Inputs in, const FwdOut out) {
  extern __shared__ __align__(16) float smem[];
  float* hid_s = smem;                    // [CH][T]
  float* act_s = hid_s + CH * T;          // [CH][ACT_LD]
  float* geo_s = act_s + CH * ACT_LD;     // [CH][GEO]
  float* out_s = geo_s + CH * GEO;        // [CH][OUT_LD]
  float* ai_s = out_s + CH * OUT_LD;      // [T]
  float* hsum_s = ai_s + T;               // [4][T]
  float* node_s = hsum_s + 4 * T;         // q_i[4], t_i[3]
  float* fold_s = node_s + 8;             // [FOLD]

  const int row = blockIdx.x;             // b * N + i
  const int b = row / in.N;
  const int i = row - b * in.N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const LoopW lw = loop_w(in.w);

  if (tid < T) ai_s[tid] = in.ai[(size_t)row * T + tid];
  if (tid < 4) node_s[tid] = in.qi[(size_t)row * 4 + tid];
  if (tid >= 4 && tid < 7) node_s[tid] = in.ti[(size_t)row * 3 + tid - 4];
  if (tid < FOLD) fold_s[tid] = (tid == F_M) ? -1e30f : 0.f;

  HeadUnit<BF16> hu;
  hu.load_row(lw, tid);
  hu.load_coef(lw, tid, tid / T == 2 ? in.tor[(size_t)row * T + tid - 2 * T] : 0.f);
  float hid_acc = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < in.NP; j0 += CH) {
    const int nj = min(CH, in.NP - j0);
    hid_acc += build_chunk<BF16>(in.aj, in.qj, in.tj, in.edge, in.mask, ai_s, node_s, hid_s, geo_s,
                                 b, i, row, in.NP, j0, nj, tid);
    __syncthreads();
    head_chunk<BF16>(hu, hid_s, geo_s, act_s, tid);
    __syncthreads();
    lin2_chunk<BF16>(lw, act_s, out_s, warp, lane);
    __syncthreads();
    if (warp == 0) fold_chunk(geo_s, out_s, fold_s, lane, nj);
  }

  hsum_s[tid] = hid_acc;
  __syncthreads();  // also publishes warp 0's last fold
  if (tid < T) {
    out.HID[(size_t)row * T + tid] =
        hsum_s[tid] + hsum_s[T + tid] + hsum_s[2 * T + tid] + hsum_s[3 * T + tid];
  }
  if (tid == 0) {
    out.m[row] = fold_s[F_M];
    out.D[row] = fold_s[F_D];
    out.CNT[row] = fold_s[F_CNT];
  } else if (tid < 5) {
    out.GD[(size_t)row * 4 + tid - 1] = fold_s[F_GD + tid - 1];
  } else if (tid < 5 + NTOR) {
    out.TA[(size_t)row * NTOR + tid - 5] = fold_s[F_TA + tid - 5];
  } else if (tid < 5 + NTOR + 3) {
    out.TR[(size_t)row * 3 + tid - 5 - NTOR] = fold_s[F_TR + tid - 5 - NTOR];
  }
}

// per-neighbour records of the backward
constexpr int NB_LD = 12;   // d(q_j)[4], d(q_j^-1)[4], d(t_j)[3]
constexpr int RED_LD = 8;   // d(local quat)[4], wad . d(att), waq . d(att)
constexpr int CT_M = 0, CT_D = 1, CT_GD = 2, CT_TA = 6, CT_TR = 13, CT_N = 16;

constexpr size_t BWD_SMEM_FLOATS = HEADS * T                         // whm
                                   + CH * T + CH * ACT_LD + CH * GEO  // hid, act / d(pre_heads), geo
                                   + 2 * CH * OUT_LD                  // lin2 out, d(lin2 out)
                                   + CH * NB_LD + CH * RED_LD         // neighbour records
                                   + 16 * T + 2 * T + 8 + CT_N;       // d(a_i) partials, a_i, d(HID), node, cotangents
constexpr size_t BWD_SMEM_BYTES = BWD_SMEM_FLOATS * sizeof(float);

template <bool BF16>
__global__ void __launch_bounds__(HEADS, 1)
    egnn_loop_bwd_kernel(const Inputs in, const BwdIO io) {
  extern __shared__ __align__(16) float smem[];
  float* whm_s = smem;                    // [HEADS][T], rounded in bf16 mode
  float* hid_s = whm_s + HEADS * T;       // [CH][T]
  float* act_s = hid_s + CH * T;          // [CH][ACT_LD] act, then d(pre_heads)
  float* geo_s = act_s + CH * ACT_LD;     // [CH][GEO]
  float* out_s = geo_s + CH * GEO;        // [CH][OUT_LD] lin2 outputs
  float* dout_s = out_s + CH * OUT_LD;    // [CH][OUT_LD] their cotangents
  float* nb_s = dout_s + CH * OUT_LD;     // [CH][NB_LD]
  float* red_s = nb_s + CH * NB_LD;       // [CH][RED_LD]
  float* dai_s = red_s + CH * RED_LD;     // [16][T]
  float* ai_s = dai_s + 16 * T;           // [T]
  float* ghid_s = ai_s + T;               // [T]
  float* node_s = ghid_s + T;             // q_i[4], t_i[3]
  float* ct_s = node_s + 8;               // m, g_D, g_GD[4], g_TA[7], g_TR[3]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head = tid / T;               // warp-uniform
  const int uu = tid - head * T;
  const int o0 = head_row0(head), no = head_rows(head);
  const int kq = tid & 15, jp = tid >> 4;  // phase D: columns 4kq..4kq+3, neighbours 2jp, 2jp+1
  const LoopW lw = loop_w(in.w);
  const int NP = in.NP;

  HeadUnit<BF16> hu;
  hu.load_row(lw, tid);
  for (int e = tid; e < HEADS * T; e += HEADS) whm_s[e] = rnd<BF16>(lw.whm[e]);
  float w2u[7];  // this unit's column of its head's lin2 rows
#pragma unroll
  for (int q = 0; q < 7; ++q) w2u[q] = q < no ? rnd<BF16>(lw.w2[(o0 + q) * T + uu]) : 0.f;

  // weight gradients, summed over every row of this block
  float dwhm[T];
#pragma unroll
  for (int k = 0; k < T; ++k) dwhm[k] = 0.f;
  float dw2a[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float accb = 0.f;                        // this unit's bias
  float accx[4] = {0.f, 0.f, 0.f, 0.f};    // att: wad, waq; rot: wrq[4]
  float db2 = 0.f;                         // lin2 bias row tid (tid < NOUT)

  for (int row = blockIdx.x; row < in.B * in.N; row += gridDim.x) {
    const int b = row / in.N;
    const int i = row - b * in.N;
    __syncthreads();  // the previous row's readers are done
    if (tid < T) {
      ai_s[tid] = in.ai[(size_t)row * T + tid];
      ghid_s[tid] = io.gHID[(size_t)row * T + tid];
    }
    if (tid < 4) node_s[tid] = in.qi[(size_t)row * 4 + tid];
    if (tid >= 4 && tid < 7) node_s[tid] = in.ti[(size_t)row * 3 + tid - 4];
    if (tid == 32) ct_s[CT_M] = io.m[row];
    if (tid == 33) ct_s[CT_D] = io.gD[row];
    if (tid >= 34 && tid < 38) ct_s[CT_GD + tid - 34] = io.gGD[(size_t)row * 4 + tid - 34];
    if (tid >= 38 && tid < 38 + NTOR) ct_s[CT_TA + tid - 38] = io.gTA[(size_t)row * NTOR + tid - 38];
    if (tid >= 45 && tid < 48) ct_s[CT_TR + tid - 45] = io.gTR[(size_t)row * 3 + tid - 45];
    hu.load_coef(lw, tid, head == 2 ? in.tor[(size_t)row * T + uu] : 0.f);
    float rowb = 0.f;                       // sum over the row's neighbours of d(pre_heads)[u]
    float dai_acc[4] = {0.f, 0.f, 0.f, 0.f};
    float dqi_l[4] = {0.f, 0.f, 0.f, 0.f};  // warp 0: this lane's d(q_i), d(t_i)
    float dti_l[3] = {0.f, 0.f, 0.f};
    __syncthreads();

    for (int j0 = 0; j0 < NP; j0 += CH) {
      const int nj = min(CH, NP - j0);
      build_chunk<BF16>(in.aj, in.qj, in.tj, in.edge, in.mask, ai_s, node_s, hid_s, geo_s, b, i, row,
                        NP, j0, nj, tid);
      __syncthreads();
      head_chunk<BF16>(hu, hid_s, geo_s, act_s, tid);
      __syncthreads();
      lin2_chunk<BF16>(lw, act_s, out_s, warp, lane);
      __syncthreads();

      // B: value-path adjoints (warp 0, lane = neighbour)
      if (warp == 0) {
        const float* g = geo_s + lane * GEO;
        const float* ov = out_s + lane * OUT_LD;
        const float* inv = g + G_INV;
        const float* q_j = g + G_QJ;
        const float* dx = g + G_DX;
        const float logit = ov[0] - (1.f - g[G_MASK]) * 1e9f;
        const float e = lane < nj ? expf(logit - ct_s[CT_M]) : 0.f;
        float ld[4], u[4], gdl[4], c1[4], c2[4];
        for (int c = 0; c < 4; ++c) ld[c] = 1.f / (1.f + expf(-ov[1 + c]));
        qmul(ld, inv, u);
        qmul(q_j, u, gdl);
        const float mtr = ov[12];
        float ge = ct_s[CT_D];
        for (int c = 0; c < 4; ++c) ge += ct_s[CT_GD + c] * gdl[c];
        for (int k = 0; k < NTOR; ++k) ge += ct_s[CT_TA + k] * ov[5 + k];
        for (int c = 0; c < 3; ++c) ge += ct_s[CT_TR + c] * mtr * dx[c];
        float* dv = dout_s + lane * OUT_LD;
        dv[0] = e * ge;
        float dgd[4], dmtr = 0.f;
        for (int c = 0; c < 4; ++c) dgd[c] = e * ct_s[CT_GD + c];
        for (int k = 0; k < NTOR; ++k) dv[5 + k] = e * ct_s[CT_TA + k];
        float* nb = nb_s + lane * NB_LD;
        for (int c = 0; c < 3; ++c) {
          const float dmr = e * ct_s[CT_TR + c];
          dmtr += dmr * dx[c];
          dti_l[c] += dmr * mtr;
          nb[8 + c] = -dmr * mtr;
        }
        dv[12] = dmtr;
        // gdelta = q_j (x) u, u = ld (x) inv: d a = g (x) conj(b), d b = conj(a) (x) g
        qconj(u, c1);
        qmul(dgd, c1, nb);                   // d(q_j), first term
        qconj(q_j, c1);
        float du[4];
        qmul(c1, dgd, du);
        qconj(inv, c1);
        qmul(du, c1, c2);                    // d(ld)
        for (int c = 0; c < 4; ++c) dv[1 + c] = c2[c] * ld[c] * (1.f - ld[c]);
        qconj(ld, c1);
        qmul(c1, du, nb + 4);                // d(q_j^-1), first term
      }
      __syncthreads();

      // C: lin2 backward through unit tid, its weight gradients
      if (tid < NOUT) {
        for (int jj = 0; jj < CH; ++jj) db2 += dout_s[jj * OUT_LD + tid];
      }
      for (int jj = 0; jj < CH; ++jj) {
        const float* dv = dout_s + jj * OUT_LD;
        const float a = act_s[jj * ACT_LD + tid];
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          if (q < no) {
            const float d = rnd<BF16>(dv[o0 + q]);
            dw2a[q] = fmaf(d, a, dw2a[q]);
            s = fmaf(w2u[q], d, s);
          }
        }
        const float dph = a > 0.f ? s : 0.f;
        act_s[jj * ACT_LD + tid] = dph;
        rowb += dph;
        const float* g = geo_s + jj * GEO;
        if (head == 0) {
          accx[0] = fmaf(dph, g[G_ND2], accx[0]);
          accx[1] = fmaf(dph, g[G_QD2], accx[1]);
        } else if (head == 1) {
#pragma unroll
          for (int c = 0; c < 4; ++c) accx[c] = fmaf(rnd<BF16>(dph), rnd<BF16>(g[G_LQ + c]), accx[c]);
        }
        const float dr = rnd<BF16>(dph);
        const float4* h4 = reinterpret_cast<const float4*>(hid_s + jj * T);
#pragma unroll
        for (int k = 0; k < T / 4; ++k) {
          const float4 x = h4[k];
          dwhm[4 * k + 0] = fmaf(dr, x.x, dwhm[4 * k + 0]);
          dwhm[4 * k + 1] = fmaf(dr, x.y, dwhm[4 * k + 1]);
          dwhm[4 * k + 2] = fmaf(dr, x.z, dwhm[4 * k + 2]);
          dwhm[4 * k + 3] = fmaf(dr, x.w, dwhm[4 * k + 3]);
        }
      }
      __syncthreads();

      // D: d(hid) = whm^T d(pre_heads) + d(HID), gated by relu'(pre)
      {
        float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
        const float* d0 = act_s + (2 * jp) * ACT_LD;
        const float* d1 = d0 + ACT_LD;
#pragma unroll 4
        for (int u = 0; u < HEADS; ++u) {
          const float4 wv = *reinterpret_cast<const float4*>(whm_s + u * T + 4 * kq);
          const float x0 = rnd<BF16>(d0[u]), x1 = rnd<BF16>(d1[u]);
          acc0[0] = fmaf(wv.x, x0, acc0[0]);
          acc0[1] = fmaf(wv.y, x0, acc0[1]);
          acc0[2] = fmaf(wv.z, x0, acc0[2]);
          acc0[3] = fmaf(wv.w, x0, acc0[3]);
          acc1[0] = fmaf(wv.x, x1, acc1[0]);
          acc1[1] = fmaf(wv.y, x1, acc1[1]);
          acc1[2] = fmaf(wv.z, x1, acc1[2]);
          acc1[3] = fmaf(wv.w, x1, acc1[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int jj = 2 * jp + r;
          if (jj < nj) {
            const int j = j0 + jj;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int k = 4 * kq + c;
              const float dh = (r == 0 ? acc0[c] : acc1[c]) + ghid_s[k];
              const float dpre = hid_s[jj * T + k] > 0.f ? dh : 0.f;
              dai_acc[c] += dpre;
              atomicAdd(io.daj + ((size_t)b * NP + j) * T + k, dpre);
              atomicAdd(io.dedge + ((size_t)i * NP + j) * T + k, dpre);
            }
          }
        }
      }

      // E: per neighbour, sums over the head units (warp w: neighbours w, w + 8, ...)
      for (int jj = warp; jj < CH; jj += HEADS / 32) {
        const float* d = act_s + jj * ACT_LD;
        const float da0 = d[lane], da1 = d[lane + 32];            // attention units
        const float dr0 = rnd<BF16>(d[T + lane]), dr1 = rnd<BF16>(d[T + lane + 32]);  // rotation
        float v[6];
        v[4] = lw.wad[lane] * da0 + lw.wad[lane + 32] * da1;
        v[5] = lw.waq[lane] * da0 + lw.waq[lane + 32] * da1;
        for (int c = 0; c < 4; ++c)
          v[c] = rnd<BF16>(lw.wrq[lane * 4 + c]) * dr0 + rnd<BF16>(lw.wrq[(lane + 32) * 4 + c]) * dr1;
        for (int c = 0; c < 6; ++c) v[c] = warp_sum(v[c]);
        if (lane == 0) {
          for (int c = 0; c < 6; ++c) red_s[jj * RED_LD + c] = v[c];
        }
      }
      __syncthreads();

      // F: quaternion and distance adjoints (warp 0, lane = neighbour)
      if (warp == 0 && lane < nj) {
        const int j = j0 + lane;
        const float* g = geo_s + lane * GEO;
        const float* q_i = node_s;
        const float* q_j = g + G_QJ;
        const float* inv = g + G_INV;
        const float* dx = g + G_DX;
        const float* dl = red_s + lane * RED_LD;
        float* nb = nb_s + lane * NB_LD;
        float dqj[4], dinv[4], dtj[3], v[4], c1[4], t4[4];
        for (int c = 0; c < 4; ++c) {
          dqj[c] = nb[c];
          dinv[c] = nb[4 + c];
        }
        for (int c = 0; c < 3; ++c) dtj[c] = nb[8 + c];
        // local = inv (x) v, v = q_i (x) q_j
        qmul(q_i, q_j, v);
        qconj(v, c1);
        qmul(dl, c1, t4);
        for (int c = 0; c < 4; ++c) dinv[c] += t4[c];
        qconj(inv, c1);
        float dv4[4];
        qmul(c1, dl, dv4);
        qconj(q_j, c1);
        qmul(dv4, c1, t4);
        for (int c = 0; c < 4; ++c) dqi_l[c] += t4[c];
        qconj(q_i, c1);
        qmul(c1, dv4, t4);
        for (int c = 0; c < 4; ++c) dqj[c] += t4[c];
        // inv = conj(q_j) / sq; divide by sq twice (the 1e-30 guard squared underflows)
        const float sq = fmaxf(q_j[0] * q_j[0] + q_j[1] * q_j[1] + q_j[2] * q_j[2] + q_j[3] * q_j[3],
                               1e-30f);
        qconj(q_j, c1);
        float ds = 0.f;
        for (int c = 0; c < 4; ++c) ds += dinv[c] * c1[c] / sq;
        ds = -ds / sq;
        dqj[0] += dinv[0] / sq;
        for (int c = 1; c < 4; ++c) dqj[c] -= dinv[c] / sq;
        for (int c = 0; c < 4; ++c) dqj[c] += 2.f * q_j[c] * ds;
        // attention extras: -d2 and qdot^2
        const float dd2 = -dl[4];
        const float qdot = q_i[0] * q_j[0] + q_i[1] * q_j[1] + q_i[2] * q_j[2] + q_i[3] * q_j[3];
        const float dqdot = 2.f * qdot * dl[5];
        for (int c = 0; c < 3; ++c) {
          dti_l[c] += 2.f * dd2 * dx[c];
          dtj[c] -= 2.f * dd2 * dx[c];
        }
        for (int c = 0; c < 4; ++c) {
          dqi_l[c] += dqdot * q_j[c];
          dqj[c] += dqdot * q_i[c];
        }
        for (int c = 0; c < 4; ++c) atomicAdd(io.dqj + ((size_t)b * NP + j) * 4 + c, dqj[c]);
        for (int c = 0; c < 3; ++c) atomicAdd(io.dtj + ((size_t)b * NP + j) * 3 + c, dtj[c]);
      }
      __syncthreads();
    }

    // row end: d(a_i), d(tor_node), d(q_i), d(t_i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dai_s[jp * T + 4 * kq + c] = dai_acc[c];
    if (head == 2) io.dtor[(size_t)row * T + uu] = rowb;
    accb += rowb;
    if (warp == 0) {
      for (int c = 0; c < 4; ++c) dqi_l[c] = warp_sum(dqi_l[c]);
      for (int c = 0; c < 3; ++c) dti_l[c] = warp_sum(dti_l[c]);
      if (lane == 0) {
        for (int c = 0; c < 4; ++c) io.dqi[(size_t)row * 4 + c] = dqi_l[c];
        for (int c = 0; c < 3; ++c) io.dti[(size_t)row * 3 + c] = dti_l[c];
      }
    }
    __syncthreads();
    if (tid < T) {
      float s = 0.f;
      for (int p = 0; p < 16; ++p) s += dai_s[p * T + tid];
      io.dai[(size_t)row * T + tid] = s;
    }
  }

  // this block's weight-gradient partial sums
  float* part = io.partial + (size_t)blockIdx.x * W_SIZE;
#pragma unroll
  for (int k = 0; k < T; ++k) part[O_WHM + tid * T + k] = dwhm[k];
  if (head == 0) {
    part[O_WAD + uu] = accx[0];
    part[O_WAQ + uu] = accx[1];
    part[O_BA1 + uu] = accb;
  } else if (head == 1) {
    part[O_BR1 + uu] = accb;
    for (int c = 0; c < 4; ++c) part[O_WRQ + uu * 4 + c] = accx[c];
  } else if (head == 2) {
    part[O_BT1 + uu] = accb;
  } else {
    part[O_BL1 + uu] = accb;
  }
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    if (q < no) part[O_W2 + (o0 + q) * T + uu] = dw2a[q];
  }
  if (tid < NOUT) part[O_B2 + tid] = db2;
}

// dw[k] = sum over blocks of partial[block][k], in block order
__global__ void egnn_loop_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                        int blocks) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= W_SIZE) return;
  float s = 0.f;
  for (int p = 0; p < blocks; ++p) s += partial[(size_t)p * W_SIZE + k];
  dw[k] = s;
}

// The dynamic shared-memory opt-in, once per device and kernel.
template <typename K>
cudaError_t smem_opt_in(K kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <bool BF16>
int launch_fwd(Inputs in, FwdOut out, cudaStream_t stream) {
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = smem_opt_in(egnn_loop_fwd_kernel<BF16>, FWD_SMEM_BYTES, done);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&in, &out};
  err = cudaLaunchKernel(egnn_loop_fwd_kernel<BF16>, dim3(in.B * in.N), dim3(HEADS), args,
                         FWD_SMEM_BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_bwd(Inputs in, BwdIO io, float* dw, int blocks, cudaStream_t stream) {
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = smem_opt_in(egnn_loop_bwd_kernel<BF16>, BWD_SMEM_BYTES, done);
  if (err != cudaSuccess) return (int)err;
  const size_t nbr = (size_t)in.B * in.NP;
  if ((err = cudaMemsetAsync(io.daj, 0, nbr * T * sizeof(float), stream)) != cudaSuccess ||
      (err = cudaMemsetAsync(io.dqj, 0, nbr * 4 * sizeof(float), stream)) != cudaSuccess ||
      (err = cudaMemsetAsync(io.dtj, 0, nbr * 3 * sizeof(float), stream)) != cudaSuccess ||
      (err = cudaMemsetAsync(io.dedge, 0, (size_t)in.N * in.NP * T * sizeof(float), stream)) !=
          cudaSuccess)
    return (int)err;
  void* args[] = {&in, &io};
  err = cudaLaunchKernel(egnn_loop_bwd_kernel<BF16>, dim3(blocks), dim3(HEADS), args, BWD_SMEM_BYTES,
                         stream);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const float* partial = io.partial;
  void* rargs[] = {&partial, &dw, &blocks};
  err = cudaLaunchKernel(egnn_loop_reduce_kernel, dim3((W_SIZE + 255) / 256), dim3(256), rargs, 0,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pmhc

extern "C" {

// Length in floats of the flat loop-weight buffer.
int egnn_loop_weights_size() { return pmhc::W_SIZE; }

// Blocks of the backward kernel for ``rows`` query rows: as many as fit
// on the current device at once, at most one per row; <= 0 on error.
int egnn_loop_bwd_blocks(int rows) {
  using namespace pmhc;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  static std::atomic<bool> done[MAX_DEVICES];
  if (smem_opt_in(egnn_loop_bwd_kernel<false>, BWD_SMEM_BYTES, done) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, egnn_loop_bwd_kernel<false>, HEADS,
                                                    BWD_SMEM_BYTES) != cudaSuccess)
    return -1;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  return rows < cap ? rows : cap;
}

int egnn_loop_fwd_launch(const float* w, const float* ai, const float* tor, const float* qi,
                         const float* ti, const float* aj, const float* qj, const float* tj,
                         const float* edge, const float* mask, float* m, float* D, float* GD,
                         float* TA, float* TR, float* HID, float* CNT, int B, int N, int NP,
                         int bf16, void* stream) {
  using namespace pmhc;
  if (B < 1 || N < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  const Inputs in = {w, ai, tor, qi, ti, aj, qj, tj, edge, mask, B, N, NP};
  const FwdOut out = {m, D, GD, TA, TR, HID, CNT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<true>(in, out, s) : launch_fwd<false>(in, out, s);
}

int egnn_loop_bwd_launch(const float* w, const float* ai, const float* tor, const float* qi,
                         const float* ti, const float* aj, const float* qj, const float* tj,
                         const float* edge, const float* mask, const float* m, const float* gD,
                         const float* gGD, const float* gTA, const float* gTR, const float* gHID,
                         float* dai, float* dtor, float* dqi, float* dti, float* daj, float* dqj,
                         float* dtj, float* dedge, float* dw, float* partial, int B, int N, int NP,
                         int bf16, int blocks, void* stream) {
  using namespace pmhc;
  if (B < 1 || N < 1 || NP < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const Inputs in = {w, ai, tor, qi, ti, aj, qj, tj, edge, mask, B, N, NP};
  const BwdIO io = {m, gD, gGD, gTA, gTR, gHID, dai, dtor, dqi, dti, daj, dqj, dtj, dedge, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<true>(in, io, dw, blocks, s) : launch_bwd<false>(in, io, dw, blocks, s);
}

}  // extern "C"
