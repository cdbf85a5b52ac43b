// Constants and device helpers shared by the port's EGNN kernels: the
// fused sampler layer (egnn_fused.cu), the training loop (egnn_loop.cu)
// and the round-1 layer (egnn_pallas.cu). The widths (T, HEADS, NTOR,
// NOUT), the layouts of the per-neighbour geometry record and of the
// online-softmax state, the loop weights' pointers (LoopW), bf16 rounding
// (rnd: round to nearest even, or nothing in fp32 mode), quaternion
// product and conjugate, and a warp maximum. The neighbour-tile loop of
// the fused layer and the loop forward is in egnn_tile.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace pmhc {

constexpr int T = 64;               // hidden width of every MLP
constexpr int HEADS = 4 * T;        // head hidden units: attention, rotation, torsion, translation
constexpr int NTOR = 7;
constexpr int NOUT = 13;            // lin2 rows: att 1, rot 4, tor 7, trl 1
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

}  // namespace pmhc
