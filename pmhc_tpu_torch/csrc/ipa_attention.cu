// Invariant point attention's attention for Hopper (sm_90a), fp32: the
// part of ESMFold's structure module (AlphaFold2 Suppl. Algorithm 22,
// lines 7-10) between its projections and linear_out, in one launch a
// block of the structure network.
//
// Replaces no TPU kernel: the JAX package has no structure network. It is
// the port's second score network's attention
// (pmhc_tpu_torch/models/structure.py), which no other kernel computes.
// Plain PyTorch twin: pmhc_tpu_torch/ops/ipa_attention.py::ipa_attention_plain.
//
// One block of 256 threads per (complex b, query row i), all 12 heads.
// It reads z[b, i, :, :] (L x 128 floats) from device memory into shared
// memory once, and from that copy computes both products with z: the 12
// pair biases z_ij . w_b,h + b_b,h and, after the softmax, o_pair,hi =
// sum_j a_hij z_ij. Around them:
//   - the scalar logits q_hi . k_hj * sqrt(1/(3*16));
//   - the point term -1/2 softplus(gamma_h) sqrt(1/(3*4*9/2))
//     sum_p |T_i q_hip - T_j k_hjp|^2 (the points come in the global
//     frame, the frames applied by the caller);
//   - the mask inf * (m_i m_j - 1) and an fp32 max-subtracted softmax over
//     the L keys (accurate expf, IEEE division);
//   - o [12, 16], o_pt [12, 8, 3] summed in the global frame and taken
//     back into frame i (R_i^T (o_pt - t_i)), |o_pt| with eps, and
//     o_pair [12, 128]: exactly what linear_out concatenates, written in
//     ESMFold's order (o, o_pt x, y, z, norms, o_pair: 2,112 floats a row).
// The widths are compile-time constants of the published config (12
// heads, 16 hidden, 4 query/key points, 8 value points, 128 pair
// features); L is a runtime input of at most MAX_L.
//
// Bound. At B = 64, L = 96 a launch reads z once, 302 MB, and ~25 MB of
// projections, points, frames and outputs: ~0.098 ms at 3.35 TB/s against
// ~4.7 GFLOP, 0.070 ms at the fp32 67 TFLOP/s. Memory-bound at ~0.1 ms.
// Each block also reads every key row of its complex (k, v and their
// points, 313 KB at L = 96) from L2: one block a query row re-reads them
// L times, ~1.9 GB of L2 traffic a launch, which a design with several
// query rows a block would cut.
//
// Design: z's row block staged once with 16-byte loads at a row stride of
// 132 floats, so that a warp's 32 rows read 16-byte pieces from 32
// distinct banks (the bias) and a warp's 64 columns read along a row (the
// output); the bias's thread holds one key row and six heads, reading
// z[j][c..c+3] and broadcast w_b[h][c..c+3]; the softmax a warp a head;
// o_pair a thread per two columns, six heads and half of the keys, the
// halves summed through shared memory; the probabilities kept [j][12] so
// a thread's six heads are one broadcast read.

#include <cuda_runtime.h>

#include <math.h>

#include <atomic>

namespace pmhc {
namespace {

constexpr int H = 12, C = 16, PQ = 4, PV = 8, CZ = 128;
constexpr int KV = 2 * C;             // a head's k and v in linear_kv's output
constexpr int PKV = PQ + PV;          // a head's k and v points
constexpr int OUT = H * (C + 4 * PV + CZ);
constexpr int O_PT = H * C;           // offsets of the parts in a row of out
constexpr int O_NORM = O_PT + 3 * H * PV;
constexpr int O_PAIR = O_NORM + H * PV;
constexpr int THREADS = 256;
constexpr int HG = 6;                 // heads a thread holds in the bias and o_pair
constexpr int ZS = CZ + 4;            // shared row stride of z
constexpr int MAX_L = 256;
constexpr int MAX_DEVICES = 64;

struct Smem {
  int z, wb, a, red, q, qp, opt, hw, bb, total;
};

__host__ __device__ inline Smem smem_layout(int L) {
  Smem s;
  s.z = 0;
  s.wb = s.z + L * ZS;                // [H][CZ]
  s.a = s.wb + H * CZ;                // [L][H] logits, then probabilities
  s.red = s.a + L * H;                // [H][CZ] o_pair's second half
  s.q = s.red + H * CZ;               // [H * C] q_i
  s.qp = s.q + H * C;                 // [H * PQ * 3] q points of row i
  s.opt = s.qp + H * PQ * 3;          // [H * PV * 3] o_pt in the global frame
  s.hw = s.opt + H * PV * 3;          // [H] point weights
  s.bb = s.hw + H;                    // [H] b_b
  s.total = s.bb + H;
  return s;
}

// dynamic shared memory of a launch over L rows, in bytes
inline int smem_bytes(int L) { return (int)(smem_layout(L).total * sizeof(float)); }

__device__ inline float softplus(float x) {
  // torch.nn.functional.softplus (beta 1, threshold 20)
  return x > 20.f ? x : log1pf(expf(x));
}

__global__ void __launch_bounds__(THREADS)
ipa_attention_kernel(const float* __restrict__ q,       // [B, L, H * C]
                     const float* __restrict__ kv,      // [B, L, H * 2C]
                     const float* __restrict__ qpts,    // [B, L, H * PQ, 3] global
                     const float* __restrict__ kvpts,   // [B, L, H * PKV, 3] global
                     const float* __restrict__ rot,     // [B, L, 3, 3]
                     const float* __restrict__ trans,   // [B, L, 3]
                     const float* __restrict__ mask,    // [B, L]
                     const float* __restrict__ z,       // [B, L, L, CZ]
                     const float* __restrict__ wb,      // [H, CZ]
                     const float* __restrict__ bb,      // [H]
                     const float* __restrict__ head_w,  // [H]
                     float* __restrict__ out,           // [B, L, OUT]
                     int L, float inf, float eps) {
  extern __shared__ __align__(16) float smem[];
  const Smem S = smem_layout(L);
  float* zs = smem + S.z;
  float* ws = smem + S.wb;
  float* as = smem + S.a;
  float* red = smem + S.red;
  float* qs = smem + S.q;
  float* qps = smem + S.qp;
  float* opt = smem + S.opt;
  float* hws = smem + S.hw;
  float* bbs = smem + S.bb;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;          // b * L + i
  const int b = row / L;
  const size_t key0 = (size_t)b * L;   // the complex's first row

  // z[b, i] and the row's inputs into shared memory
  const float4* z4 = reinterpret_cast<const float4*>(z + (size_t)row * L * CZ);
  for (int n = tid; n < L * (CZ / 4); n += THREADS) {
    const int j = n / (CZ / 4), c4 = n % (CZ / 4);
    *reinterpret_cast<float4*>(zs + j * ZS + 4 * c4) = z4[n];
  }
  for (int n = tid; n < H * CZ; n += THREADS) ws[n] = wb[n];
  for (int n = tid; n < H * C; n += THREADS) qs[n] = q[(size_t)row * H * C + n];
  for (int n = tid; n < H * PQ * 3; n += THREADS) qps[n] = qpts[(size_t)row * H * PQ * 3 + n];
  if (tid < H) {
    hws[tid] = softplus(head_w[tid]) * sqrtf(1.f / (3.f * (PQ * 9.f / 2.f)));
    bbs[tid] = bb[tid];
  }
  const float mi = mask[row];
  __syncthreads();

  // the logits: a thread a key row j and six heads
  {
    const int hg = tid / 128, h0 = HG * hg;
    const float scale_qk = sqrtf(1.f / (3.f * C)), scale_b = sqrtf(1.f / 3.f);
    for (int j = tid % 128; j < L; j += 128) {
      float acc[HG] = {};
      for (int c = 0; c < CZ; c += 4) {
        const float4 zv = *reinterpret_cast<const float4*>(zs + j * ZS + c);
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
          const float4 w = *reinterpret_cast<const float4*>(ws + (h0 + hh) * CZ + c);
          acc[hh] = fmaf(zv.x, w.x, acc[hh]);
          acc[hh] = fmaf(zv.y, w.y, acc[hh]);
          acc[hh] = fmaf(zv.z, w.z, acc[hh]);
          acc[hh] = fmaf(zv.w, w.w, acc[hh]);
        }
      }
      const float mterm = inf * (mi * mask[key0 + j] - 1.f);
      const float* kj = kv + (key0 + j) * (H * KV);
      const float* kpj = kvpts + (key0 + j) * (H * PKV * 3);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const int h = h0 + hh;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot = fmaf(qs[h * C + c], kj[h * KV + c], dot);
        float pt = 0.f;
#pragma unroll
        for (int p = 0; p < PQ * 3; ++p) {
          const float d = qps[h * PQ * 3 + p] - kpj[h * PKV * 3 + p];
          pt = fmaf(d, d, pt);
        }
        as[j * H + h] = dot * scale_qk + scale_b * (acc[hh] + bbs[h]) - 0.5f * (pt * hws[h])
                        + mterm;
      }
    }
  }
  __syncthreads();

  // the softmax over the keys: a warp a head
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int h = warp; h < H; h += THREADS / 32) {
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, as[j * H + h]);
#pragma unroll
      for (int s = 16; s > 0; s /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(as[j * H + h] - m);
        as[j * H + h] = e;
        sum += e;
      }
#pragma unroll
      for (int s = 16; s > 0; s /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, s);
      for (int j = lane; j < L; j += 32) as[j * H + h] = as[j * H + h] / sum;
    }
  }
  __syncthreads();

  float* orow = out + (size_t)row * OUT;
  // o and o_pt (global frame): a thread an output, reading the keys' rows
  for (int u = tid; u < H * C + H * PV * 3; u += THREADS) {
    float acc = 0.f;
    if (u < H * C) {
      const int h = u / C, c = u % C;
      const float* vp = kv + key0 * (H * KV) + h * KV + C + c;
      for (int j = 0; j < L; ++j) acc = fmaf(as[j * H + h], vp[(size_t)j * H * KV], acc);
      orow[u] = acc;
    } else {
      const int v = u - H * C, h = v / (PV * 3), r = v % (PV * 3);
      const float* vp = kvpts + key0 * (H * PKV * 3) + h * PKV * 3 + PQ * 3 + r;
      for (int j = 0; j < L; ++j) acc = fmaf(as[j * H + h], vp[(size_t)j * H * PKV * 3], acc);
      opt[v] = acc;
    }
  }
  // o_pair: a thread two columns, six heads and half of the keys
  {
    const int cp = tid % 64, hg = (tid / 64) % 2, half = tid / 128, h0 = HG * hg;
    float acc[HG][2] = {};
    for (int j = half; j < L; j += 2) {
      const float2 zv = *reinterpret_cast<const float2*>(zs + j * ZS + 2 * cp);
      const float2 a01 = *reinterpret_cast<const float2*>(as + j * H + h0);
      const float2 a23 = *reinterpret_cast<const float2*>(as + j * H + h0 + 2);
      const float2 a45 = *reinterpret_cast<const float2*>(as + j * H + h0 + 4);
      const float a[HG] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        acc[hh][0] = fmaf(a[hh], zv.x, acc[hh][0]);
        acc[hh][1] = fmaf(a[hh], zv.y, acc[hh][1]);
      }
    }
    if (half == 1) {
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        red[(h0 + hh) * CZ + 2 * cp] = acc[hh][0];
        red[(h0 + hh) * CZ + 2 * cp + 1] = acc[hh][1];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const int at = (h0 + hh) * CZ + 2 * cp;
        orow[O_PAIR + at] = acc[hh][0] + red[at];
        orow[O_PAIR + at + 1] = acc[hh][1] + red[at + 1];
      }
    }
  }
  // o_pt back into frame i, and its norms (opt was written before the
  // barrier above)
  if (tid < H * PV) {
    const float* R = rot + (size_t)row * 9;
    const float* ti = trans + (size_t)row * 3;
    const float d0 = opt[tid * 3] - ti[0], d1 = opt[tid * 3 + 1] - ti[1],
                d2 = opt[tid * 3 + 2] - ti[2];
    float loc[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) loc[x] = R[x] * d0 + R[3 + x] * d1 + R[6 + x] * d2;
    orow[O_PT + tid] = loc[0];
    orow[O_PT + H * PV + tid] = loc[1];
    orow[O_PT + 2 * H * PV + tid] = loc[2];
    orow[O_NORM + tid] = sqrtf(loc[0] * loc[0] + loc[1] * loc[1] + loc[2] * loc[2] + eps);
  }
}

}  // namespace
}  // namespace pmhc

extern "C" {

int ipa_attention_launch(const float* q, const float* kv, const float* qpts, const float* kvpts,
                         const float* rot, const float* trans, const float* mask, const float* z,
                         const float* wb, const float* bb, const float* head_w, float* out,
                         int B, int L, float inf, float eps, void* stream) {
  using namespace pmhc;
  if (B < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  // the opt-in for MAX_L's shared memory, once a device (not a stream
  // operation: a CUDA graph's capture finds it made by the eager warm-up)
  static std::atomic<bool> opted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(ipa_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(MAX_L));
    if (err != cudaSuccess) return (int)err;
    opted[dev].store(true, std::memory_order_release);
  }
  const int bytes = smem_bytes(L);
  void* args[] = {&q, &kv, &qpts, &kvpts, &rot, &trans, &mask, &z, &wb, &bb, &head_w, &out,
                  &L, &inf, &eps};
  err = cudaLaunchKernel(ipa_attention_kernel, dim3(B * L), dim3(THREADS), args, bytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
