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
// the edge terms): bound by operations. fp32 FMA peak 67 TFLOP/s ->
// >= ~0.064 / 0.065 ms (chip_smoke.py::work_of_pallas counts it from the
// run's shapes).
//
// Design. One block of 256 threads per query row (b, i): B*N = 1,024
// blocks at B = 64, two resident per SM (__launch_bounds__(256, 2),
// ~68 KB of dynamic shared memory each). All NP <= 96 neighbours of the
// row stay in shared memory: the message tile [96][68] and one hidden
// tile [96][68] that holds h_all first and then each MLP's hidden
// activations in turn, the per-neighbour geometry and the 13 head outputs.
// Every [NP, K] x [K, 64] product runs on the CUDA cores as tile_mm:
// thread (column c = tid % 64, row group g = tid / 64) keeps 24 row sums
// in registers, reads its weight column from L2 (each weight read once
// per block, coalesced across c; a layer's weights, ~150-165 KB, are
// shared by all blocks) and the input rows as float4 broadcasts from
// shared memory: 96 FMA per 4 weight loads and 24 shared loads. The
// per-neighbour head lin2 rows are thread-per-(neighbour, output) dots,
// the softmax and the 14 weighted neighbour sums are warp reductions,
// and thread 0 writes the geometry. The neighbour projection
// h_j @ mw1[H:2H] is part of #3's body and is recomputed per row, as on
// the TPU: 16x the work the layer needs for it (6 / 15 % of the kernel's
// FLOP at H = 23 / 64), which a redesign can hoist. fp32 IEEE FMA throughout (no TF32, no tensor cores: wgmma and
// TMA are later work).
//
// Interface: plain C, loaded with ctypes. The launcher allocates
// nothing, launches on the caller's stream through cudaLaunchKernel and
// returns cudaGetLastError().

#include "egnn_common.cuh"

#include <stddef.h>

#include <atomic>

namespace pmhc {
namespace {

constexpr int MAX_DEVICES = 64;
constexpr int THREADS = 256;
constexpr int M = T;                // message width
constexpr int MAXNP = 96;           // neighbours per row held in shared memory
constexpr int GROUPS = THREADS / T; // row groups of tile_mm
constexpr int RPT = MAXNP / GROUPS; // tile rows per thread
constexpr int LD = T + 4;           // tile row stride (float4-aligned)
constexpr int PG = 20;              // per-neighbour geometry record
constexpr int PO = 16;              // per-neighbour head outputs
constexpr int NODE = 24;            // q_i[4] t_i[3] tors14[14]
constexpr int NSUM = 14;            // weighted sums: gd[4], delta_a[7], translation[3]

// geometry record: d2, qdot^2, local quat[4], q_j^-1[4], q_j[4], dx[3], mask
constexpr int P_D2 = 0, P_QD2 = 1, P_LQ = 2, P_INV = 6, P_QJ = 10, P_DX = 14, P_MASK = 17;
// head outputs: logit, rotation lin2 (before the sigmoid) [4], torsion delta [7],
// translation scalar, softmax weight
constexpr int O_LOGIT = 0, O_ROT = 1, O_TOR = 5, O_TR = 12, O_W = 13;

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

constexpr size_t SMEM_FLOATS = 2 * MAXNP * LD + MAXNP * PG + MAXNP * PO  // tiles, records
                               + 5 * T + NODE + 16;                    // row vectors, sums
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// acc[r] = sum_{k < K} in[(g + GROUPS r) * LD + k] * W[k * T + c]. The input
// rows are read as float4 up to K rounded up to 4 (the caller zeroes the
// padding columns); weight rows at k >= K read as 0.
__device__ __forceinline__ void tile_mm(const float* in_s, int K, const float* __restrict__ W,
                                        int c, int g, float acc[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float w0 = __ldg(W + (k + 0) * T + c);
    const float w1 = k + 1 < K ? __ldg(W + (k + 1) * T + c) : 0.f;
    const float w2 = k + 2 < K ? __ldg(W + (k + 2) * T + c) : 0.f;
    const float w3 = k + 3 < K ? __ldg(W + (k + 3) * T + c) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(in_s + (g + GROUPS * r) * LD + k);
      acc[r] = fmaf(w3, x.w, fmaf(w2, x.z, fmaf(w1, x.y, fmaf(w0, x.x, acc[r]))));
    }
  }
}

// out[j * PO + base + o] = sum_k hid[j * LD + k] * W2[k * nout + o] + b2[o],
// one thread per (neighbour, output).
__device__ __forceinline__ void lin2_rows(const float* hid_s, const float* __restrict__ W2,
                                          const float* __restrict__ b2, int nout, int base,
                                          float* ho, int NP, int tid) {
  for (int e = tid; e < NP * nout; e += THREADS) {
    const int j = e / nout;
    const int o = e - j * nout;
    const float* hr = hid_s + j * LD;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < T; ++k) s = fmaf(hr[k], __ldg(W2 + k * nout + o), s);
    ho[j * PO + base + o] = s + b2[o];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
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
                   int N, int NP, int H, int E, int O) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // [MAXNP][LD] h_all, then each MLP's hidden tile
  float* tm = ta + MAXNP * LD;      // [MAXNP][LD] message
  float* geo = tm + MAXNP * LD;     // [MAXNP][PG] neighbour geometry
  float* ho = geo + MAXNP * PG;     // [MAXNP][PO] head outputs
  float* hi_s = ho + MAXNP * PO;    // [T] h_i (H <= T)
  float* ai_s = hi_s + T;           // [T] h_i @ mw1[:H] + mb1
  float* tn_s = ai_s + T;           // [T] torsion node term tors14_i @ tw1[M:]
  float* ms_s = tn_s + T;           // [M] message summed over all NP slots
  float* fh_s = ms_s + M;           // [T] feature MLP hidden
  float* node_s = fh_s + T;         // [NODE]
  float* red_s = node_s + NODE;     // [16] weighted sums, then the mask count

  const int row = blockIdx.x;       // b * N + i
  const int b = row / N;
  const int i = row - b * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = tid % T;
  const int g = tid / T;
  const int HP = (H + 3) & ~3;      // h_all columns, padded to a multiple of 4
  const Offsets off = weight_offsets(H, E, O);
  float acc[RPT];

  // -- 1. the row's inputs ---------------------------------------------------
  for (int e = tid; e < NP * HP; e += THREADS) {
    const int j = e / HP;
    const int k = e - j * HP;
    ta[j * LD + k] = k < H ? h_all[((size_t)b * NP + j) * H + k] : 0.f;
  }
  if (tid < H) hi_s[tid] = h[(size_t)row * H + tid];
  if (tid < 4) {
    node_s[tid] = qi[(size_t)row * 4 + tid];
  } else if (tid < 7) {
    node_s[tid] = ti[(size_t)row * 3 + tid - 4];
  } else if (tid < 7 + 2 * NTOR) {
    node_s[tid] = tors[(size_t)row * 2 * NTOR + tid - 7];
  }
  __syncthreads();

  if (tid < NP) {  // neighbour geometry, one thread per neighbour
    const int j = tid;
    const float* q_i = node_s;
    const float* t_i = node_s + 4;
    float q_j[4], dx[3];
    for (int k = 0; k < 4; ++k) q_j[k] = qj[((size_t)b * NP + j) * 4 + k];
    for (int k = 0; k < 3; ++k) dx[k] = t_i[k] - tj[((size_t)b * NP + j) * 3 + k];
    const float qdot = q_i[0] * q_j[0] + q_i[1] * q_j[1] + q_i[2] * q_j[2] + q_i[3] * q_j[3];
    // zero-quat guard: padded frames may carry all-zero quats
    const float n2 = fmaxf(q_j[0] * q_j[0] + q_j[1] * q_j[1] + q_j[2] * q_j[2] + q_j[3] * q_j[3],
                           1e-30f);
    const float inv[4] = {q_j[0] / n2, -q_j[1] / n2, -q_j[2] / n2, -q_j[3] / n2};
    float tmp[4], lq[4];
    qmul(q_i, q_j, tmp);
    qmul(inv, tmp, lq);
    float* gr = geo + j * PG;
    gr[P_D2] = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
    gr[P_QD2] = qdot * qdot;
    for (int k = 0; k < 4; ++k) {
      gr[P_LQ + k] = lq[k];
      gr[P_INV + k] = inv[k];
      gr[P_QJ + k] = q_j[k];
    }
    for (int k = 0; k < 3; ++k) gr[P_DX + k] = dx[k];
    gr[P_MASK] = mask[(size_t)row * NP + j];
  }
  if (tid < T) {  // node terms: a_i (with the message bias) and the torsion node term
    float a = 0.f;
    for (int k = 0; k < H; ++k) a = fmaf(hi_s[k], __ldg(w + off.mw1 + k * T + tid), a);
    ai_s[tid] = a + w[off.mb1 + tid];
    float tn = 0.f;
    for (int k = 0; k < 2 * NTOR; ++k)
      tn = fmaf(node_s[7 + k], __ldg(w + off.tw1 + (M + k) * T + tid), tn);
    tn_s[tid] = tn;
  }

  // -- 2. message MLP: hid = relu(a_i + h_j @ mw1[H:2H] + edge), msg = hid @ mw2 + mb2
  tile_mm(ta, H, w + off.mw1 + H * T, c, g, acc);
  __syncthreads();  // a_i ready; every read of the h_all tile done
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = g + GROUPS * r;
    if (j < NP) ta[j * LD + c] = fmaxf(acc[r] + ai_s[c] + edge[((size_t)i * NP + j) * T + c], 0.f);
  }
  __syncthreads();
  tile_mm(ta, T, w + off.mw2, c, g, acc);
  {
    const float bias = w[off.mb2 + c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int j = g + GROUPS * r;
      if (j < NP) tm[j * LD + c] = acc[r] + bias;
    }
  }
  __syncthreads();

  // -- 3. the four heads over the message tile ---------------------------------
  // attention: relu(msg @ aw1[:M] - d2 aw1[M] + qdot^2 aw1[M+1] + ab1) -> logit
  tile_mm(tm, M, w + off.aw1, c, g, acc);
  __syncthreads();  // the previous readers of ta are done
  {
    const float wd = w[off.aw1 + M * T + c], wq = w[off.aw1 + (M + 1) * T + c];
    const float bias = w[off.ab1 + c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int j = g + GROUPS * r;
      if (j < NP) {
        const float* gr = geo + j * PG;
        ta[j * LD + c] = fmaxf(acc[r] + (-gr[P_D2]) * wd + gr[P_QD2] * wq + bias, 0.f);
      }
    }
  }
  __syncthreads();
  lin2_rows(ta, w + off.aw2, w + off.ab2, 1, O_LOGIT, ho, NP, tid);

  // rotation: relu(msg @ rw1[:M] + lq @ rw1[M:M+4] + rb1) -> 4 (sigmoid later)
  tile_mm(tm, M, w + off.rw1, c, g, acc);
  __syncthreads();
  {
    const float* wr = w + off.rw1 + M * T + c;
    const float w0 = wr[0], w1 = wr[T], w2 = wr[2 * T], w3 = wr[3 * T];
    const float bias = w[off.rb1 + c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int j = g + GROUPS * r;
      if (j < NP) {
        const float* lq = geo + j * PG + P_LQ;
        const float x = lq[0] * w0 + lq[1] * w1 + lq[2] * w2 + lq[3] * w3;
        ta[j * LD + c] = fmaxf(acc[r] + x + bias, 0.f);
      }
    }
  }
  __syncthreads();
  lin2_rows(ta, w + off.rw2, w + off.rb2, 4, O_ROT, ho, NP, tid);

  // torsion: relu(msg @ tw1[:M] + tors14_i @ tw1[M:] + tb1) -> 7
  tile_mm(tm, M, w + off.tw1, c, g, acc);
  __syncthreads();
  {
    const float node = tn_s[c] + w[off.tb1 + c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int j = g + GROUPS * r;
      if (j < NP) ta[j * LD + c] = fmaxf(acc[r] + node, 0.f);
    }
  }
  __syncthreads();
  lin2_rows(ta, w + off.tw2, w + off.tb2, NTOR, O_TOR, ho, NP, tid);

  // translation: relu(msg @ lw1 + lb1) -> 1
  tile_mm(tm, M, w + off.lw1, c, g, acc);
  __syncthreads();
  {
    const float bias = w[off.lb1 + c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int j = g + GROUPS * r;
      if (j < NP) ta[j * LD + c] = fmaxf(acc[r] + bias, 0.f);
    }
  }
  __syncthreads();
  lin2_rows(ta, w + off.lw2, w + off.lb2, 1, O_TR, ho, NP, tid);
  __syncthreads();  // every head output written

  // -- 4. exact softmax over all NP (warp 0); the message sum (warps 2-3) -----
  if (warp == 0) {
    float l[MAXNP / 32], e[MAXNP / 32];
    float mx = -INFINITY, cnt = 0.f;
#pragma unroll
    for (int s = 0; s < MAXNP / 32; ++s) {
      const int j = lane + 32 * s;
      if (j < NP) {
        const float mk = geo[j * PG + P_MASK];
        l[s] = ho[j * PO + O_LOGIT] - (1.f - mk) * 1e9f;
        mx = fmaxf(mx, l[s]);
        cnt += mk;
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < MAXNP / 32; ++s) {
      const int j = lane + 32 * s;
      if (j < NP) {
        e[s] = expf(l[s] - mx);
        sum += e[s];
      }
    }
    sum = warp_sum(sum);
    cnt = warp_sum(cnt);
#pragma unroll
    for (int s = 0; s < MAXNP / 32; ++s) {
      const int j = lane + 32 * s;
      if (j < NP) ho[j * PO + O_W] = e[s] / sum;
    }
    if (lane == 0) red_s[NSUM] = cnt;
  } else if (tid >= 2 * 32 && tid < 2 * 32 + M) {
    const int m = tid - 2 * 32;
    float s = 0.f;
    for (int j = 0; j < NP; ++j) s += tm[j * LD + m];
    ms_s[m] = s;
  }
  __syncthreads();

  // -- 5. per-neighbour weighted terms into the hidden tile, then their sums --
  if (tid < NP) {
    const int j = tid;
    const float* gr = geo + j * PG;
    const float* oj = ho + j * PO;
    const float wj = oj[O_W];
    // sigmoid output used UNNORMALIZED: gdelta = q_j (x) (delta (x) q_j^-1)
    float dl[4], t1[4], gdl[4];
    for (int k = 0; k < 4; ++k) dl[k] = 1.f / (1.f + expf(-oj[O_ROT + k]));
    qmul(dl, gr + P_INV, t1);
    qmul(gr + P_QJ, t1, gdl);
    float* cr = ta + j * LD;
    for (int k = 0; k < 4; ++k) cr[k] = gdl[k] * wj;
    for (int k = 0; k < NTOR; ++k) cr[4 + k] = oj[O_TOR + k] * wj;
    const float mw = oj[O_TR] * wj;
    for (int k = 0; k < 3; ++k) cr[4 + NTOR + k] = mw * gr[P_DX + k];
  }
  if (tid >= T && tid < 2 * T) {  // feature MLP hidden (warps 2-3)
    const int u = tid - T;
    float a = 0.f;
    for (int k = 0; k < H; ++k) a = fmaf(hi_s[k], __ldg(w + off.fw1 + k * T + u), a);
    float s = 0.f;
    for (int m = 0; m < M; ++m) s = fmaf(ms_s[m], __ldg(w + off.fw1 + (H + m) * T + u), s);
    fh_s[u] = fmaxf(a + s + w[off.fb1 + u], 0.f);
  }
  __syncthreads();
  for (int s = warp; s < NSUM; s += THREADS / 32) {
    float v = 0.f;
    for (int j = lane; j < NP; j += 32) v += ta[j * LD + s];
    v = warp_sum(v);
    if (lane == 0) red_s[s] = v;
  }
  if (tid < O) {
    float a = 0.f;
    for (int u = 0; u < T; ++u) a = fmaf(fh_s[u], __ldg(w + off.fw2 + u * O + tid), a);
    out_feat[(size_t)row * O + tid] = a + w[off.fb2 + tid];
  }
  __syncthreads();

  // -- 6. geometry finalize --------------------------------------------------
  if (tid == 0) {
    const float* q_i = node_s;
    const float* t_i = node_s + 4;
    const float* tor = node_s + 7;
    float g4[4];
    if (red_s[NSUM] > 0.f) {
      for (int k = 0; k < 4; ++k) g4[k] = red_s[k];
    } else {  // no neighbour: identity rotation
      g4[0] = 1.f;
      g4[1] = g4[2] = g4[3] = 0.f;
    }
    float nrm = fmaxf(sqrtf(g4[0] * g4[0] + g4[1] * g4[1] + g4[2] * g4[2] + g4[3] * g4[3]), 1e-12f);
    for (int k = 0; k < 4; ++k) g4[k] /= nrm;
    float uq[4];
    qmul(g4, q_i, uq);
    nrm = fmaxf(sqrtf(uq[0] * uq[0] + uq[1] * uq[1] + uq[2] * uq[2] + uq[3] * uq[3]), 1e-12f);
    for (int k = 0; k < 4; ++k) out_q[(size_t)row * 4 + k] = uq[k] / nrm;
    for (int k = 0; k < 3; ++k) out_t[(size_t)row * 3 + k] = t_i[k] + red_s[4 + NTOR + k];
    for (int k = 0; k < NTOR; ++k) {
      const float da = red_s[4 + k];
      const float sd = sinf(da), cd = cosf(da);
      const float st = tor[2 * k], ct = tor[2 * k + 1];
      out_tors[(size_t)row * 2 * NTOR + 2 * k] = sd * ct + cd * st;
      out_tors[(size_t)row * 2 * NTOR + 2 * k + 1] = cd * ct - sd * st;
    }
  }
}

int launch(const float* w, const float* h, const float* h_all, const float* qi, const float* ti,
           const float* qj, const float* tj, const float* tors, const float* mask,
           const float* edge, float* out_q, float* out_t, float* out_tors, float* out_feat,
           int B, int N, int NP, int H, int E, int O, cudaStream_t stream) {
  // the shared-memory opt-in is set once per device
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(egnn_pallas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  void* args[] = {&w, &h, &h_all, &qi, &ti, &qj, &tj, &tors, &mask, &edge,
                  &out_q, &out_t, &out_tors, &out_feat, &N, &NP, &H, &E, &O};
  err = cudaLaunchKernel(egnn_pallas_kernel, dim3(B * N), dim3(THREADS), args, SMEM_BYTES, stream);
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
  if (H < 1 || H > T || E < 0 || O < 1 || O > THREADS || B < 1 || N < 1 || NP < 1 ||
      NP > MAXNP)
    return (int)cudaErrorInvalidValue;
  return launch(w, h, h_all, qi, ti, qj, tj, tors, mask, edge, out_q, out_t, out_tors, out_feat,
                B, N, NP, H, E, O, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
