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
// Steps (a)-(d) live in egnn_common.cuh, shared with the training loop
// kernels of egnn_loop.cu.
//
// Modes (template BF16): fp32 is IEEE fp32 FMA throughout (no TF32).
// bf16 rounds every MLP matmul operand to bf16 (round to nearest even)
// and accumulates in fp32; geometry, softmax and the fold stay fp32.
// Both run on the CUDA cores; tensor cores (wgmma) are later work.
//
// Interface: plain C, loaded with ctypes. The launcher allocates
// nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include "egnn_common.cuh"

#include <stddef.h>

#include <atomic>

namespace pmhc {
namespace {

constexpr int MAX_DEVICES = 64;
constexpr int NODE = 24;            // q_i[4] t_i[3] tors14[14]

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
  const LoopW lw = {w + off.whm, w + off.wad, w + off.waq, w + off.ba1, w + off.br1,
                    w + off.bt1, w + off.bl1, w + off.wrq, w + off.w2, w + off.b2};

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

  // this thread's head hidden unit; the torsion head's node term is
  // wtt @ tors14 (interleaved s0 c0 s1 c1 ...)
  HeadUnit<BF16> hu;
  hu.load_row(lw, tid);
  float tn = 0.f;
  if (tid / T == 2) {
    const int uu = tid - 2 * T;
    for (int k = 0; k < 2 * NTOR; ++k)
      tn = fmaf(rnd<BF16>(w[off.wtt + uu * 2 * NTOR + k]), rnd<BF16>(node_s[7 + k]), tn);
  }
  hu.load_coef(lw, tid, tn);

  // online-softmax state lives in shared memory (keeps registers for the whm row)
  if (tid < FOLD) fold_s[tid] = (tid == F_M) ? -1e30f : 0.f;
  float hid_acc = 0.f;  // sum of relu(pre) for column tid % T over this thread's neighbours
  __syncthreads();      // ai_s ready

  for (int j0 = 0; j0 < NP; j0 += CH) {
    const int nj = min(CH, NP - j0);
    hid_acc += build_chunk<BF16>(aj, qj, tj, edge, mask, ai_s, node_s, hid_s, geo_s, b, i, row, NP,
                                 j0, nj, tid);
    __syncthreads();
    head_chunk<BF16>(hu, hid_s, geo_s, act_s, tid);
    __syncthreads();
    lin2_chunk<BF16>(lw, act_s, out_s, warp, lane);
    __syncthreads();
    if (warp == 0) fold_chunk(geo_s, out_s, fold_s, lane, nj);
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
    const float* gd = fold_s + F_GD;
    const float* ta = fold_s + F_TA;
    const float* tr = fold_s + F_TR;
    const float cnt = fold_s[F_CNT];
    const float inv_d = 1.f / fold_s[F_D];
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
  void* args[] = {&w, &h, &qi, &ti, &tors, &aj, &qj, &tj, &edge, &mask,
                  &out_q, &out_t, &out_tors, &out_feat, &N, &NP, &H, &O};
  err = cudaLaunchKernel(egnn_fused_kernel<BF16>, dim3(B * N), dim3(HEADS), args, SMEM_BYTES, stream);
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
