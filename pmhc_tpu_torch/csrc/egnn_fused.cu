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
// Bound. Per (b, i, j) pair: 256x64 MACs (head lin1) + 13x64 (lin2) +
// 4x64 (rot term) + a few hundred FLOP of geometry and fold, ~35 kFLOP.
// At B=64, N=16, NP=96: 98,304 pairs, ~3.4 GFLOP per launch against
// ~1.7 MB of inputs, most of it a_j: bound by operations, not bytes.
// fp32 FMA peak 67 TFLOP/s -> >= ~51 us per launch.
//
// Design. One block of 256 threads per query row (b, i): B*N = 1,024
// blocks at B=64, two resident per SM (__launch_bounds__(256, 2),
// <= 128 registers, ~47 KB dynamic shared memory each), so 264 rows in
// flight on 132 SMs. Thread u owns head hidden unit u: its whm row (64
// floats) lives in registers for the whole launch, so the 256x64 head
// product per pair reads only the neighbour's hid vector, broadcast from
// shared memory as float4 (16 FMA per 4 shared loads, 4 neighbours in
// flight per thread for ILP). Neighbours go in chunks of 32: (a) all
// threads build the chunk's hid tile and warp 0 its geometry records;
// (b) every thread computes its unit for the 32 neighbours into a padded
// act tile (row stride 257: conflict-free column reads); (c) warp w
// computes lin2 row w (and w + 8) with lane = neighbour; (d) warp 0
// folds the chunk into the online softmax with shuffle reductions.
//
// Modes (template BF16): fp32 is IEEE fp32 FMA throughout (no TF32).
// bf16 rounds every MLP matmul operand to bf16 (round to nearest even)
// and accumulates in fp32; geometry, softmax and the fold stay fp32.
// Both run on the CUDA cores; tensor cores (wgmma) are later work.
//
// Interface: plain C, loaded with ctypes. The launcher allocates
// nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include <atomic>

namespace {

constexpr int MAX_DEVICES = 64;

constexpr int T = 64;               // hidden width of every MLP
constexpr int HEADS = 4 * T;        // head hidden units = threads per block
constexpr int NTOR = 7;
constexpr int CH = 32;              // neighbours per chunk (= warp size)
constexpr int ACT_LD = HEADS + 1;   // padded row stride of the act tile
constexpr int NOUT = 13;            // lin2 rows: att 1, rot 4, tor 7, trl 1
constexpr int OUT_LD = 16;
constexpr int GEO = 20;             // floats per neighbour geometry record
constexpr int NODE = 24;            // q_i[4] t_i[3] tors14[14]
constexpr int FOLD = 20;            // m, D, GD[4], TA[7], TR[3], CNT

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

constexpr size_t SMEM_FLOATS =
    CH * T + CH * ACT_LD + CH * GEO + CH * OUT_LD  // chunk tiles
    + T + T                                        // a_i, h_i
    + 4 * T + T + NODE + FOLD;                     // HID partials, feat hidden, node, fold
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

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

template <bool BF16>
__global__ void __launch_bounds__(HEADS, 2)
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
                  int N, int NP, int H, int O) {
  extern __shared__ __align__(16) float smem[];
  float* hid_s = smem;                    // [CH][T] relu(pre), rounded in bf16 mode
  float* act_s = hid_s + CH * T;          // [CH][ACT_LD] relu(head pre-activations)
  float* geo_s = act_s + CH * ACT_LD;     // [CH][GEO] neighbour geometry
  float* out_s = geo_s + CH * GEO;        // [CH][OUT_LD] lin2 outputs
  float* ai_s = out_s + CH * OUT_LD;      // [T]
  float* hi_s = ai_s + T;                 // [T] (H <= T)
  float* hsum_s = hi_s + T;               // [4][T] HID partial sums
  float* fh_s = hsum_s + 4 * T;           // [T] feature MLP hidden
  float* node_s = fh_s + T;               // [NODE]
  float* fold_s = node_s + NODE;          // [FOLD] online-softmax state (warp 0)

  const int row = blockIdx.x;             // b * N + i
  const int b = row / N;
  const int i = row - b * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Offsets off = weight_offsets(H, O);

  if (tid < H) hi_s[tid] = h[(size_t)row * H + tid];
  if (tid < 4) {
    node_s[tid] = qi[(size_t)row * 4 + tid];
  } else if (tid < 7) {
    node_s[tid] = ti[(size_t)row * 3 + tid - 4];
  } else if (tid < 7 + 2 * NTOR) {
    node_s[tid] = tors[(size_t)row * 2 * NTOR + tid - 7];
  }
  __syncthreads();

  // a_i = wmi @ h_i + bm1
  if (tid < T) {
    const float* wr = w + off.wmi + tid * H;
    float acc = 0.f;
    for (int k = 0; k < H; ++k) acc = fmaf(rnd<BF16>(wr[k]), rnd<BF16>(hi_s[k]), acc);
    ai_s[tid] = acc + w[off.bm1 + tid];
  }

  // this thread's head hidden unit: whm row in registers, extra-term coefficients
  float wreg[T];
  {
    const float4* wr4 = reinterpret_cast<const float4*>(w + off.whm + tid * T);
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const float4 v = wr4[k];
      wreg[4 * k + 0] = rnd<BF16>(v.x);
      wreg[4 * k + 1] = rnd<BF16>(v.y);
      wreg[4 * k + 2] = rnd<BF16>(v.z);
      wreg[4 * k + 3] = rnd<BF16>(v.w);
    }
  }
  const int head = tid / T;  // 0 att, 1 rot, 2 tor, 3 transl (warp-uniform)
  const int uu = tid - head * T;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, cb;
  if (head == 0) {
    c0 = w[off.wad + uu];
    c1 = w[off.waq + uu];
    cb = w[off.ba1 + uu];
  } else if (head == 1) {
    c0 = rnd<BF16>(w[off.wrq + uu * 4 + 0]);
    c1 = rnd<BF16>(w[off.wrq + uu * 4 + 1]);
    c2 = rnd<BF16>(w[off.wrq + uu * 4 + 2]);
    c3 = rnd<BF16>(w[off.wrq + uu * 4 + 3]);
    cb = w[off.br1 + uu];
  } else if (head == 2) {
    float tn = 0.f;  // torsion node term wtt @ tors14 (interleaved s0 c0 s1 c1 ...)
    for (int k = 0; k < 2 * NTOR; ++k)
      tn = fmaf(rnd<BF16>(w[off.wtt + uu * 2 * NTOR + k]), rnd<BF16>(node_s[7 + k]), tn);
    cb = tn + w[off.bt1 + uu];
  } else {
    cb = w[off.bl1 + uu];
  }

  // online-softmax state lives in shared memory (keeps registers for wreg)
  if (tid < FOLD) fold_s[tid] = (tid == 0) ? -1e30f : 0.f;
  float hid_acc = 0.f;  // sum of relu(pre) for column tid % T over this thread's neighbours
  __syncthreads();      // ai_s ready

  for (int j0 = 0; j0 < NP; j0 += CH) {
    const int nj = min(CH, NP - j0);

    // (a) hid tile; HEADS % T == 0, so each thread always owns column tid % T
    for (int e = tid; e < CH * T; e += HEADS) {
      const int jj = e / T;
      const int k = e - jj * T;
      float v = 0.f;
      if (jj < nj) {
        const int j = j0 + jj;
        const float pre = ai_s[k] + aj[((size_t)b * NP + j) * T + k] +
                          edge[((size_t)i * NP + j) * T + k];
        v = fmaxf(pre, 0.f);
        hid_acc += v;
      }
      hid_s[e] = rnd<BF16>(v);
    }
    // geometry records, one neighbour per lane of warp 0
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
        g[0] = -d2;
        g[1] = qdot * qdot;
        for (int c = 0; c < 4; ++c) {
          g[2 + c] = lq[c];
          g[6 + c] = inv[c];
          g[10 + c] = q_j[c];
        }
        for (int c = 0; c < 3; ++c) g[14 + c] = dx[c];
        g[17] = mask[(size_t)row * NP + j];
      } else {
        for (int c = 0; c < GEO; ++c) g[c] = 0.f;
      }
    }
    __syncthreads();

    // (b) unit tid of the four head pre-activations, 4 neighbours at a time
    for (int jj0 = 0; jj0 < CH; jj0 += 4) {
      const float4* h0 = reinterpret_cast<const float4*>(hid_s + (jj0 + 0) * T);
      const float4* h1 = reinterpret_cast<const float4*>(hid_s + (jj0 + 1) * T);
      const float4* h2 = reinterpret_cast<const float4*>(hid_s + (jj0 + 2) * T);
      const float4* h3 = reinterpret_cast<const float4*>(hid_s + (jj0 + 3) * T);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < T / 4; ++k) {
        const float4 x0 = h0[k], x1 = h1[k], x2 = h2[k], x3 = h3[k];
        const float w0 = wreg[4 * k], w1 = wreg[4 * k + 1], w2 = wreg[4 * k + 2], w3 = wreg[4 * k + 3];
        acc[0] = fmaf(w3, x0.w, fmaf(w2, x0.z, fmaf(w1, x0.y, fmaf(w0, x0.x, acc[0]))));
        acc[1] = fmaf(w3, x1.w, fmaf(w2, x1.z, fmaf(w1, x1.y, fmaf(w0, x1.x, acc[1]))));
        acc[2] = fmaf(w3, x2.w, fmaf(w2, x2.z, fmaf(w1, x2.y, fmaf(w0, x2.x, acc[2]))));
        acc[3] = fmaf(w3, x3.w, fmaf(w2, x3.z, fmaf(w1, x3.y, fmaf(w0, x3.x, acc[3]))));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* g = geo_s + (jj0 + q) * GEO;
        float extra;
        if (head == 0) {
          extra = c0 * g[0] + c1 * g[1] + cb;
        } else if (head == 1) {
          extra = c0 * rnd<BF16>(g[2]) + c1 * rnd<BF16>(g[3]) + c2 * rnd<BF16>(g[4]) +
                  c3 * rnd<BF16>(g[5]) + cb;
        } else {
          extra = cb;
        }
        act_s[(jj0 + q) * ACT_LD + tid] = rnd<BF16>(fmaxf(acc[q] + extra, 0.f));
      }
    }
    __syncthreads();

    // (c) block-diagonal lin2: row o reads its head's 64 units; lane = neighbour
    for (int o = warp; o < NOUT; o += HEADS / 32) {
      const int sec = (o == 0) ? 0 : (o < 5) ? 1 : (o < 12) ? 2 : 3;
      const float* wrow = w + off.w2 + o * T;
      const float* arow = act_s + lane * ACT_LD + sec * T;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < T; ++k) acc = fmaf(rnd<BF16>(__ldg(wrow + k)), arow[k], acc);
      out_s[lane * OUT_LD + o] = acc + w[off.b2 + o];
    }
    __syncthreads();

    // (d) fold the chunk into the online softmax (warp 0, lane = neighbour)
    if (warp == 0) {
      const float* g = geo_s + lane * GEO;
      const float* ov = out_s + lane * OUT_LD;
      const bool valid = lane < nj;
      const float mk = g[17];
      const float logit = valid ? ov[0] - (1.f - mk) * 1e9f : -INFINITY;
      const float m_run = fold_s[0];
      const float m_new = fmaxf(m_run, warp_max(logit));
      const float r = expf(m_run - m_new);
      const float l = valid ? expf(logit - m_new) : 0.f;
      // sigmoid output used UNNORMALIZED: gdelta = q_j (x) (delta (x) q_j^-1)
      float dl[4], t1[4], gdl[4];
      for (int c = 0; c < 4; ++c) dl[c] = 1.f / (1.f + expf(-ov[1 + c]));
      qmul(dl, g + 6, t1);
      qmul(g + 10, t1, gdl);
      // every lane holds the same reduced values; lane 0 stores them
      float upd[FOLD];
      upd[0] = m_new;
      upd[1] = fold_s[1] * r + warp_sum(l);
      for (int c = 0; c < 4; ++c) upd[2 + c] = fold_s[2 + c] * r + warp_sum(l * gdl[c]);
      for (int k = 0; k < NTOR; ++k) upd[6 + k] = fold_s[6 + k] * r + warp_sum(l * ov[5 + k]);
      for (int c = 0; c < 3; ++c) upd[13 + c] = fold_s[13 + c] * r + warp_sum(l * ov[12] * g[14 + c]);
      upd[16] = fold_s[16] + warp_sum(mk);
      __syncwarp();
      if (lane == 0) {
        for (int c = 0; c < 17; ++c) fold_s[c] = upd[c];
      }
    }
    // no barrier needed: the next chunk's first writes to geo_s are warp 0's
    // own, and out_s / act_s are rewritten only after the next barriers
  }

  // HID over all neighbours (masked included), then the feature MLP
  hsum_s[tid] = hid_acc;
  __syncthreads();
  if (tid < T) hsum_s[tid] = hsum_s[tid] + hsum_s[T + tid] + hsum_s[2 * T + tid] + hsum_s[3 * T + tid];
  __syncthreads();
  if (tid < T) {
    const float* wr = w + off.wfh + tid * H;
    float a1 = 0.f;
    for (int k = 0; k < H; ++k) a1 = fmaf(rnd<BF16>(wr[k]), rnd<BF16>(hi_s[k]), a1);
    const float* wm = w + off.wfm2 + tid * T;
    float a2 = 0.f;
    for (int k = 0; k < T; ++k) a2 = fmaf(rnd<BF16>(wm[k]), rnd<BF16>(hsum_s[k]), a2);
    fh_s[tid] = rnd<BF16>(fmaxf(a1 + a2 + w[off.bf1 + tid], 0.f));
  }
  __syncthreads();
  if (tid < O) {
    const float* wr = w + off.wf2 + tid * T;
    float a = 0.f;
    for (int k = 0; k < T; ++k) a = fmaf(rnd<BF16>(wr[k]), fh_s[k], a);
    out_feat[(size_t)row * O + tid] = a + w[off.bf2 + tid];
  }

  // geometry finalize (fold_s was last written before the barriers above)
  if (tid == 0) {
    const float* q_i = node_s;
    const float* t_i = node_s + 4;
    const float* tor = node_s + 7;
    const float* gd = fold_s + 2;
    const float* ta = fold_s + 6;
    const float* tr = fold_s + 13;
    const float cnt = fold_s[16];
    const float inv_d = 1.f / fold_s[1];
    float g4[4];
    if (cnt > 0.f) {
      for (int c = 0; c < 4; ++c) g4[c] = gd[c] * inv_d;
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
    for (int c = 0; c < 3; ++c) out_t[(size_t)row * 3 + c] = t_i[c] + tr[c] * inv_d;
    for (int k = 0; k < NTOR; ++k) {
      const float da = ta[k] * inv_d;
      const float s = sinf(da), co = cosf(da);
      const float st = tor[2 * k], ct = tor[2 * k + 1];
      out_tors[(size_t)row * 2 * NTOR + 2 * k] = s * ct + co * st;
      out_tors[(size_t)row * 2 * NTOR + 2 * k + 1] = co * ct - s * st;
    }
  }
}

template <bool BF16>
int launch(const float* w, const float* h, const float* qi, const float* ti, const float* tors,
           const float* aj, const float* qj, const float* tj, const float* edge, const float* mask,
           float* out_q, float* out_t, float* out_tors, float* out_feat,
           int B, int N, int NP, int H, int O, cudaStream_t stream) {
  // the shared-memory opt-in is set once per device and instantiation
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(egnn_fused_kernel<BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  egnn_fused_kernel<BF16><<<B * N, HEADS, SMEM_BYTES, stream>>>(
      w, h, qi, ti, tors, aj, qj, tj, edge, mask, out_q, out_t, out_tors, out_feat, N, NP, H, O);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Length in floats of the packed weight buffer for input width H and
// output width O (the Python packer checks its buffer against it).
int egnn_fused_weights_size(int H, int O) { return weight_offsets(H, O).total; }

int egnn_fused_launch(const float* w, const float* h, const float* qi, const float* ti,
                      const float* tors, const float* aj, const float* qj, const float* tj,
                      const float* edge, const float* mask, float* out_q, float* out_t,
                      float* out_tors, float* out_feat, int B, int N, int NP, int H, int O,
                      int bf16, void* stream) {
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
