// The fused sampler chain's work outside the layer kernels, for Hopper
// (sm_90a): two kernels that, with the two launches of the fused layer
// (egnn_fused.cu) and the three generator calls of the step's draws, make
// one reverse step of pmhc_tpu_torch/diffusion/sampler.py's fused chain on
// the card.
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses the elementwise body of sample_lane's scan
// (pmhc_tpu/diffusion/sampler_lane.py). On the card the same work took
// ~165 launches of PyTorch's small kernels a step, each of 1,024 rows of a
// few floats at batch 64. Plain PyTorch twins:
// pmhc_tpu_torch/ops/sampler_step.py::inter_layer_plain and step_plain.
//
// sampler_inter_kernel, between the two layer launches: from layer 1's
// outputs (q1, t1, inner) it writes layer 2's node input h2 = relu(inner)
// and the peptide rows of layer 2's neighbour inputs: a_j = h2 @ wj_t
// (a 64-wide dot per output, wj_t [H][T] staged in shared memory; in bf16
// mode both operands rounded to bf16 with fp32 sums, else IEEE fp32, as
// ops/egnn_fused.py::_project), q_j = q1 and t_j = t1.
//
// sampler_step_kernel, after layer 2's launch, over every residue row
// (padded rows included), a thread per row and torsion and one per row's
// frame: the step's noise from its raw draws (the
// translations' normal draws times the scale, Shoemake's quaternion of
// three uniforms, the torsion angles 2 pi u as (sin, cos)), then
// remove_noise_scalars at the step counter's six scalars, written in
// place into the state and into layer 1's peptide q_j / t_j; unless the
// step is the chain's last, the next step's time column of h1 and layer
// 1's peptide a_j = aj_static + xs[k + 1] * wj_time; and the counter
// advanced, by the last block to finish (every block has read it then).
// The arithmetic keeps the plain version's operation order (trans /
// alpha_ts, no reciprocals) with accurate sqrtf, acosf, sinf, cosf and
// IEEE division; nvcc may contract a product and a sum into one FMA.
//
// Bound. At B = 64, N = 16, NP = 96 a step moves ~1.7 MB (the inter-layer
// kernel ~0.85: inner in, h2 and a_j out; the step kernel ~0.86: state,
// predictions and draws in, state out, aj_static in, a_j out), ~0.5 us at
// 3.35 TB/s, and 8.4 MFLOP of projection. Both kernels are bound by
// their launches and by latency: a thread's chain of dependent accurate
// transcendentals and divisions (a row's two partial rotations, two
// partial angles a torsion). Design: enough small blocks to spread the
// 1,024 rows over many SMs (32 rows a step block, 16 an inter-layer
// block); the step's work split eight ways a row, a warp per role (each
// torsion, the frame), where a thread a row ran all of it in one chain
// (22.6 us a launch at batch 64, H100); the a_j rows, 64 floats each, written by all of a block's
// threads together so that neighbouring threads store neighbouring
// addresses; the step counter read on the device, so a CUDA graph of
// several steps replays them.

#include <cuda_runtime.h>

#include <math.h>

#include "egnn_common.cuh"

namespace pmhc {
namespace {

constexpr int INTER_ROWS = 16;                // residue rows of an inter-layer block
constexpr int INTER_THREADS = 256;            // T output units x 4 row groups
constexpr int INTER_GROUPS = INTER_THREADS / T;
constexpr int STEP_ROWS = 32;                 // residue rows of a step block
constexpr int STEP_THREADS = STEP_ROWS * (NTOR + 1);  // a warp per torsion, one for the frames
constexpr size_t INTER_SMEM = (T * T + INTER_ROWS * T) * sizeof(float);  // wj_t, the rows' h2
constexpr float TWO_PI = 6.28318530717958647692f;  // float(2 pi): PyTorch rounds the scalar so

template <bool RND>
__global__ void __launch_bounds__(INTER_THREADS)
sampler_inter_kernel(const float* __restrict__ inner,  // [R, H] layer 1's output features
                     const float* __restrict__ q1,     // [R, 4] layer 1's frames
                     const float* __restrict__ t1,     // [R, 3]
                     const float* __restrict__ wj_t,   // [H, T] layer 2's neighbour projection
                     float* __restrict__ h2,           // [R, H]
                     float* __restrict__ aj,           // [B, NP, T] layer 2's neighbour inputs
                     float* __restrict__ qj,           // [B, NP, 4]
                     float* __restrict__ tj,           // [B, NP, 3]
                     int rows, int N, int NP, int H) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                   // [H][T], rounded in bf16 mode
  float* hs = smem + T * T;          // [INTER_ROWS][T] relu(inner), rounded in bf16 mode
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * INTER_ROWS;
  const int nr = min(INTER_ROWS, rows - r0);
  for (int i = tid; i < H * T; i += INTER_THREADS) w[i] = rnd<RND>(wj_t[i]);
  for (int i = tid; i < nr * H; i += INTER_THREADS) {
    const size_t at = (size_t)r0 * H + i;
    const float v = inner[at];
    const float r = v < 0.f ? 0.f : v;  // relu (NaN stays NaN)
    h2[at] = r;
    hs[(i / H) * T + i % H] = rnd<RND>(r);
  }
  for (int i = tid; i < nr * 7; i += INTER_THREADS) {
    const int rr = r0 + i / 7, c = i % 7;
    const size_t nb = (size_t)(rr / N) * NP + rr % N;  // the row's peptide neighbour slot
    if (c < 4) {
      qj[nb * 4 + c] = q1[(size_t)rr * 4 + c];
    } else {
      tj[nb * 3 + c - 4] = t1[(size_t)rr * 3 + c - 4];
    }
  }
  __syncthreads();
  // unit c of rows g, g + 4, g + 8, g + 12: four independent sums
  const int c = tid % T, g = tid / T;
  float acc[INTER_ROWS / INTER_GROUPS] = {};
  for (int j = 0; j < H; ++j) {
    const float wv = w[j * T + c];
#pragma unroll
    for (int i = 0; i < INTER_ROWS / INTER_GROUPS; ++i) {
      acc[i] = fmaf(hs[(g + INTER_GROUPS * i) * T + j], wv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < INTER_ROWS / INTER_GROUPS; ++i) {
    const int rr = g + INTER_GROUPS * i;
    if (rr < nr) {
      const int r = r0 + rr;
      aj[((size_t)(r / N) * NP + r % N) * T + c] = acc[i];
    }
  }
}

struct StepIo {
  long long* k;               // [1] the step counter
  unsigned* ticket;           // [1] blocks of this launch done (0 between launches)
  const float* xs;            // [K] each step's model time
  const float* sched;         // [K, 6] beta_t, sigma_t, beta_s, alpha_ts, sqr_sigma_ts, sigma_t2s
  float* q;                   // [R, 4] the state, updated in place
  float* t;                   // [R, 3]
  float* tors;                // [R, 7, 2]
  const float* q_p;           // [R, 4] layer 2's predictions
  const float* t_p;           // [R, 3]
  const float* tors_p;        // [R, 7, 2]
  const float* normal;        // [R, 3] the step's draws: randn
  const float* shoemake;      // [R, 3] rand
  const float* angles;        // [R, 7] rand
  float scale;                // position_noise_scale
  float* h1;                  // [R, H1] layer 1's node input: the time column H1 - 1
  const float* aj_static;     // [R, T] layer 1's peptide a_j without the time row
  const float* wj_time;       // [T] the time row
  float* aj;                  // [B, NP, T] layer 1's neighbour inputs
  float* qj;                  // [B, NP, 4]
  float* tj;                  // [B, NP, 3]
  int K, rows, N, NP, H1;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// torch_normalize: x / max(||x||, 1e-12)
template <int D>
__device__ __forceinline__ void normalize(const float* x, float* o) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) ss += x[i] * x[i];
  const float d = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
  for (int i = 0; i < D; ++i) o[i] = x[i] / d;
}

// geometry/quat.py::partial_rot: the rotation angle of q scaled by amount
// (the output not renormalised)
__device__ __forceinline__ void partial_rot(const float* q, float amount, float* o) {
  float n[4], axis[3];
  normalize<4>(q, n);
  const float a2 = acosf(clampf(n[0], -1.f, 1.f)) * amount;
  normalize<3>(n + 1, axis);
  const float s = sinf(a2);
  o[0] = cosf(a2);
  o[1] = s * axis[0];
  o[2] = s * axis[1];
  o[3] = s * axis[2];
}

// geometry/sincos.py::partial_sin_cos: the angle of (sin, cos) scaled by amount
__device__ __forceinline__ void partial_sin_cos(const float* sc, float amount, float* o) {
  float n[2];
  normalize<2>(sc, n);
  float a = acosf(clampf(n[1], -1.f, 1.f));
  if (n[0] < 0.f) a = -a;
  a *= amount;
  o[0] = sinf(a);
  o[1] = cosf(a);
}

// geometry/sincos.py::multiply_sin_cos: the angles added
__device__ __forceinline__ void multiply_sin_cos(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[1] + a[1] * b[0];
  o[1] = a[1] * b[1] - a[0] * b[0];
}

// One row's frame: positions, the posterior mean plus the stochastic
// term; rotations, the predicted partial rotation inverted and a partial
// random (Shoemake) rotation at level s composed on. Into the state and
// layer 1's peptide q_j / t_j.
__device__ __forceinline__ void step_frame(const StepIo& a, const float* s, int r) {
  const float beta_t = s[0], sigma_t = s[1], beta_s = s[2], alpha_ts = s[3];
  const float sqr_sigma_ts = s[4], sigma_t2s = s[5];
  float pos[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float noise = a.normal[(size_t)r * 3 + c] * a.scale;
    pos[c] = a.t[(size_t)r * 3 + c] / alpha_ts -
             (a.t_p[(size_t)r * 3 + c] * sqr_sigma_ts) / (alpha_ts * sigma_t) + sigma_t2s * noise;
  }
  float rq[4], q[4], qp[4], pp[4], inv[4], m[4], pr[4], rot[4];
  const float x0 = clampf(a.shoemake[(size_t)r * 3], 0.f, 1.f);
  const float th1 = TWO_PI * clampf(a.shoemake[(size_t)r * 3 + 1], 0.f, 1.f);
  const float th2 = TWO_PI * clampf(a.shoemake[(size_t)r * 3 + 2], 0.f, 1.f);
  const float r1 = sqrtf(1.f - x0), r2 = sqrtf(x0);
  rq[0] = r2 * cosf(th2);
  rq[1] = r1 * sinf(th1);
  rq[2] = r1 * cosf(th1);
  rq[3] = r2 * sinf(th2);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q[c] = a.q[(size_t)r * 4 + c];
    qp[c] = a.q_p[(size_t)r * 4 + c];
  }
  partial_rot(qp, beta_t, pp);
  const float sq = pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2] + pp[3] * pp[3];
  inv[0] = pp[0] / sq;  // quat_invert: conjugate over the squared norm
  inv[1] = -pp[1] / sq;
  inv[2] = -pp[2] / sq;
  inv[3] = -pp[3] / sq;
  qmul(inv, q, m);
  partial_rot(rq, beta_s, pr);
  qmul(pr, m, rot);
  const size_t nb = (size_t)(r / a.N) * a.NP + r % a.N;  // the row's peptide neighbour slot
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a.q[(size_t)r * 4 + c] = rot[c];
    a.qj[nb * 4 + c] = rot[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.t[(size_t)r * 3 + c] = pos[c];
    a.tj[nb * 3 + c] = pos[c];
  }
}

// One row's torsion c: the same inversion in (sin, cos) space.
__device__ __forceinline__ void step_torsion(const StepIo& a, const float* s, int r, int c) {
  const size_t at = (size_t)r * (2 * NTOR) + 2 * c;
  const float ang = a.angles[(size_t)r * NTOR + c] * TWO_PI;
  const float rs[2] = {sinf(ang), cosf(ang)};
  const float tp[2] = {a.tors_p[at], a.tors_p[at + 1]};
  const float tc[2] = {a.tors[at], a.tors[at + 1]};
  float ps[2], pi[2], mt[2], prs[2], out[2];
  partial_sin_cos(tp, s[0], ps);
  const float ss = ps[0] * ps[0] + ps[1] * ps[1];
  pi[0] = -ps[0] / ss;  // inverse_sin_cos: the angle negated over the squared norm
  pi[1] = ps[1] / ss;
  multiply_sin_cos(pi, tc, mt);
  partial_sin_cos(rs, s[2], prs);
  multiply_sin_cos(prs, mt, out);
  a.tors[at] = out[0];
  a.tors[at + 1] = out[1];
}

// A block of STEP_ROWS rows, a warp per role: warps 0-6 a torsion each,
// warp 7 the frames (no warp diverges between roles).
__global__ void __launch_bounds__(STEP_THREADS) sampler_step_kernel(StepIo a) {
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * STEP_ROWS;
  const int r = r0 + tid % STEP_ROWS, role = tid / STEP_ROWS;
  const long long k = *a.k;
  if (r < a.rows) {
    const float* s = a.sched + k * 6;
    if (role < NTOR) {
      step_torsion(a, s, r, role);
    } else {
      step_frame(a, s, r);
    }
  }

  // the next step's model time: h1's time column and layer 1's peptide
  // a_j, the block's rows together (neighbouring threads, neighbouring units)
  if (k + 1 < a.K) {
    const float x = a.xs[k + 1];
    const int nr = min(STEP_ROWS, a.rows - r0);
    for (int i = tid; i < nr * T; i += STEP_THREADS) {
      const int rr = r0 + i / T, c = i % T;
      // the product rounded on its own, as PyTorch's x * wj_time
      a.aj[((size_t)(rr / a.N) * a.NP + rr % a.N) * T + c] =
          a.aj_static[(size_t)rr * T + c] + __fmul_rn(x, a.wj_time[c]);
    }
    if (role == NTOR && r < a.rows) a.h1[(size_t)r * a.H1 + a.H1 - 1] = x;
  }

  // every block has read the counter before it counts itself done: the
  // last one advances it
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.ticket, 1u) == gridDim.x - 1) {
      *a.ticket = 0;
      *a.k = k + 1;
    }
  }
}

}  // namespace
}  // namespace pmhc

extern "C" {

int sampler_inter_launch(const float* inner, const float* q1, const float* t1, const float* wj_t,
                         float* h2, float* aj, float* qj, float* tj, int B, int N, int NP, int H,
                         int mode, void* stream) {
  using namespace pmhc;
  if (B < 1 || N < 1 || NP < N || H < 1 || H > T) return (int)cudaErrorInvalidValue;
  if (mode != MODE_FP32 && mode != MODE_BF16 && mode != MODE_HIGH) return (int)cudaErrorInvalidValue;
  int rows = B * N;
  void* args[] = {&inner, &q1, &t1, &wj_t, &h2, &aj, &qj, &tj, &rows, &N, &NP, &H};
  const dim3 grid((rows + INTER_ROWS - 1) / INTER_ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mode == MODE_BF16
      ? cudaLaunchKernel(sampler_inter_kernel<true>, grid, dim3(INTER_THREADS), args, INTER_SMEM, s)
      : cudaLaunchKernel(sampler_inter_kernel<false>, grid, dim3(INTER_THREADS), args, INTER_SMEM, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int sampler_step_launch(long long* k, unsigned* ticket, const float* xs, const float* sched, int K,
                        float* q, float* t, float* tors, const float* q_p, const float* t_p,
                        const float* tors_p, const float* normal, const float* shoemake,
                        const float* angles, float scale, float* h1, int H1,
                        const float* aj_static, const float* wj_time, float* aj, float* qj,
                        float* tj, int B, int N, int NP, void* stream) {
  using namespace pmhc;
  if (B < 1 || N < 1 || NP < N || K < 1 || H1 < 1) return (int)cudaErrorInvalidValue;
  StepIo io{k, ticket, xs, sched, q, t, tors, q_p, t_p, tors_p, normal, shoemake, angles, scale,
            h1, aj_static, wj_time, aj, qj, tj, K, B * N, N, NP, H1};
  void* args[] = {&io};
  const dim3 grid((B * N + STEP_ROWS - 1) / STEP_ROWS);
  const cudaError_t err = cudaLaunchKernel(sampler_step_kernel, grid, dim3(STEP_THREADS), args, 0,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
