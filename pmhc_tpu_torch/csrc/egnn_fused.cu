// Fused EGNN layer forward for Hopper (sm_90a): the whole layer of
// pmhc_tpu_torch/models/egnn.py in one kernel, on pre-projected inputs.
//
// Replaces two TPU kernels that compute the same function:
//   pmhc_tpu/ops/egnn_pallas_lane.py::_make_kernel      (egnn_lane_core, f32, "high")
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
// high: three tensor-core passes (>= ~10 us) and the splits of hid and act
// on the CUDA cores.
//
// Design of fp32 and bf16: one template, two tile products. What it does about the six
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
// tiles folds them with the online merge. The tile loop (staging, build,
// prefetch, the two tile products, fold and merge) lives in egnn_tile.cuh,
// shared with the training loop's forward (egnn_loop.cu); this file adds
// the row groups' node MLPs and the finalize.
//
// Design of high (egnn_fused_kernel<MODE_HIGH>; its neighbour pipeline is
// egnn_high.cuh's, which the loop forward's high mode runs too). Measured before it
// (chip_ab.py --kernel fused --ablate on the tile-loop design, H100): the
// tile product was half the time, its epilogue and lin2 most of that, and
// the serial chain build -> product -> fold -> merge left the tensor cores
// idle through the rest. So the products move to wgmma and the chain
// becomes a pipeline of warpgroups over (row, tile) items:
// - warpgroups 0 and 1 consume: each takes a 64-row slab of the 96-row
//   hid tile (rows 0-63 and 32-95; warps 4 and 5 hold rows 32-63 twice
//   and feed zeros to the lin2 and store nothing). Per head: twelve
//   m64n64k16 (4 k-steps x hi*hi, hi*lo, lo*hi) with A = the hid tile and
//   B = whm, both split into bf16 hi and lo tiles in shared memory in
//   wgmma's 128B-swizzle layout, into a register accumulator; the
//   epilogue on it (+ extra term, relu, split into hi and lo) leaves the
//   lin2's A fragments in registers (two n8 chunks of a k16 step are one
//   A fragment), and twelve m64n16k16 add the head's lin2 rows (padded
//   to n = 16, zero outside the head) to a 64 x 16 accumulator. Two head
//   accumulators: head h + 1's product runs while head h's epilogue does.
//   A 96-row tile is not a multiple of m64: one row a slab pair wastes a
//   third of the tensor work (rows 32-63 twice), where two rows a product
//   (192 = 3 x m64) would have to pair rows across batch elements and
//   tiles; the tensor cores are not what bounds this kernel.
// - warpgroup 2 produces: it builds item k + 1's hid tile (split into hi
//   and lo, written straight into the swizzled layout) and geometry
//   records into the other of two buffers while item k's products run,
//   prefetches item k + 2's raw inputs (cp.async), folds item k - 1 once
//   its lin2 outputs (double-buffered) are in, and merges item k - 2 on a
//   warp of its own (warp 8) while warps 9-11 wait for and fold the next.
// - named barriers (bar.sync / bar.arrive with an id and a count) hand the
//   buffers over between the roles: FULL (the producer arrives after a
//   fence.proxy.async, the consumers wait) and DONE (the consumers arrive
//   after their last wgmma wait, the folding warps wait); the producer
//   has one of its own. __syncthreads only around a row group's node MLPs
//   and feature MLP, which all warps run.
// Budget: shared memory 231,280 bytes of 232,448: whm hi + lo 64 KB, lin2
// B hi + lo 16 KB, hid hi + lo 24 KB a buffer (two), raw a_j / edge / q_j
// / t_j / mask 51 KB, geometry records 2 x 7.9 KB, lin2 outputs 2 x 6.4
// KB, coefficients 5 KB, the row group's node inputs and terms 10.8 KB,
// HID and fold partials 1.5 KB, 1 KB to align the tiles to 1024 bytes. Registers: 152 of the 168 that 12
// warps leave (two head accumulators 64, the lin2's A fragments 32, its
// accumulator 8), no spills. Warps: 8 consume (6 live), 3 build and fold,
// 1 merges and writes the row outputs. Measured after it (same tool):
// 0.077 -> 0.060 ms a launch; the consumers' epilogues and the producer's
// build each take about as long as an item, the tensor cores idle most of
// it (chip_ab.py --kernel fused --phases).
//
// Modes (template MODE, egnn_common.cuh): fp32 is IEEE fp32 FMA
// throughout (no TF32). bf16 rounds every MLP matmul operand to bf16
// (round to nearest even): whm and hid, wrq and the local quaternion, w2
// and act, the node MLPs' operands; every sum stays fp32, and geometry,
// the attention's rank-1 terms, biases, softmax and fold stay fp32.
// high (--fast-f32; TPU kernel #1 with mm_maker("high")) splits the
// operands of the two tensor-core products, whm and hid, w2 and act, into
// bf16 hi + lo and sums hi*hi + hi*lo + lo*hi in fp32: three wgmma per
// product. Unlike the TPU kernel, which splits every matmul, it runs the
// rotation term and the node MLPs (wmi, wtt, wfh, wfm2, wf2) in fp32 FMA,
// as the fp32 mode does: on the CUDA cores a split would cost more and be
// less exact. The plain version does the same.
//
// Interface: plain C, loaded with ctypes. The launcher allocates
// nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include "egnn_high.cuh"

#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace pmhc {
namespace {

// node inputs: q_i[4] t_i[3] tors14 h_i[H <= T]
constexpr int N_TOR = 7, N_H = 24, NODE = N_H + T;  // N_Q = 0, N_T = 4: egnn_high.cuh

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

// Shared memory, in floats (every region 16-byte aligned): the tile loop's
// (egnn_tile.cuh), then the row groups'.
template <int MODE>
struct Smem : TileSmem<MODE> {
  static constexpr int NR = TileSmem<MODE>::END;  // next group's node inputs [RG][NODE]
  // the row group's node inputs, a_i, torsion node terms (+ bt1), HID sums
  // and feature MLP hiddens, [RG][NODE] and [RG][T]
  static constexpr int NS = NR + RG * NODE;
  static constexpr int AI = NS + RG * NODE;
  static constexpr int TN = AI + RG * T;
  static constexpr int HS = TN + RG * T;
  static constexpr int FH = HS + RG * T;
  static constexpr int TOTAL = FH + RG * T;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
  static_assert(BYTES <= 232448, "fused layer shared memory exceeds the H100's 227 KB");
};

// The row group's node terms, by all threads: a_i = wmi @ h_i + bm1 (4
// lanes per unit, threads 0-255) and the torsion head's node term wtt @
// tors14 + bt1 (2 lanes per unit, threads 256-383) of its rg rows, from
// their node inputs nr [RG][NODE], into ai and tn [RG][T]; each weight
// loaded once into registers.
template <bool RND>
__device__ __forceinline__ void node_terms(const float* __restrict__ w, const Offsets& off, const float* nr,
                                           float* ai, float* tn, int rg, int H, int tid) {
  if (tid < 4 * T) {  // a_i = wmi @ h_i + bm1: 4 lanes per unit
    const int o = tid >> 2, q = tid & 3;
    float wr[T / 4];
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk)
      wr[kk] = q + 4 * kk < H ? rnd<RND>(__ldg(w + off.wmi + o * H + q + 4 * kk)) : 0.f;
    const float bias = __ldg(w + off.bm1 + o);
    float acc[RG] = {};  // the group's rows side by side (rows past rg are not stored)
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk)
      if (q + 4 * kk < H)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr)
          acc[rr] = fmaf(wr[kk], rnd<RND>(nr[rr * NODE + N_H + q + 4 * kk]), acc[rr]);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (q == 0 && rr < rg) ai[rr * T + o] = a + bias;
    }
  } else {  // the torsion head's node term wtt @ tors14 + bt1: 2 lanes per unit
    const int o = (tid - 4 * T) >> 1, q = tid & 1;
    float wr[NTOR];
#pragma unroll
    for (int kk = 0; kk < NTOR; ++kk) wr[kk] = rnd<RND>(__ldg(w + off.wtt + o * 2 * NTOR + q + 2 * kk));
    const float bias = __ldg(w + off.bt1 + o);
    float acc[RG] = {};
#pragma unroll
    for (int kk = 0; kk < NTOR; ++kk)
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
        acc[rr] = fmaf(wr[kk], rnd<RND>(nr[rr * NODE + N_TOR + q + 2 * kk]), acc[rr]);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      const float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
      if (q == 0 && rr < rg) tn[rr * T + o] = a + bias;
    }
  }
}

// A finished row's geometry outputs, by lanes 0-10 of one warp, from its
// fold state fr and its node inputs ns: the updated quaternion (lane 0),
// translation (lanes 1-3) and torsions (lanes 4-10).
__device__ __forceinline__ void row_outputs(const float* fr, const float* ns, int row, int lane,
                                            float* __restrict__ out_q, float* __restrict__ out_t,
                                            float* __restrict__ out_tors) {
  if (lane >= 1 + 3 + NTOR) return;
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

// The feature MLP of a finished row group, by all threads (after a
// barrier): hidden = relu(wfh @ h_i + wfm2 @ HID + bf1) into fh (4 lanes
// per unit), a barrier, then feat = wf2 @ hidden + bf2 into out_feat rows
// g0 .. g0 + rg - 1; from the node inputs ns [RG][NODE] and the HID sums
// hs [RG][T]; each weight loaded once into registers.
template <bool RND>
__device__ __forceinline__ void feature_mlp(const float* __restrict__ w, const Offsets& off, const float* ns,
                                            const float* hs, float* fh, float* __restrict__ out_feat, int g0,
                                            int rg, int H, int O, int tid) {
  if (tid < 4 * T) {  // hidden = relu(wfh @ h_i + wfm2 @ HID + bf1): 4 lanes per unit
    const int o = tid >> 2, q = tid & 3;
    float wh[T / 4], wm[T / 4];
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk) {
      const int k = q + 4 * kk;
      wh[kk] = k < H ? rnd<RND>(__ldg(w + off.wfh + o * H + k)) : 0.f;
      wm[kk] = rnd<RND>(__ldg(w + off.wfm2 + o * T + k));
    }
    const float bias = __ldg(w + off.bf1 + o);
    float acc[RG] = {};
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk)
      if (q + 4 * kk < H)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr)
          acc[rr] = fmaf(wh[kk], rnd<RND>(ns[rr * NODE + N_H + q + 4 * kk]), acc[rr]);
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
        acc[rr] = fmaf(wm[kk], rnd<RND>(hs[rr * T + q + 4 * kk]), acc[rr]);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (q == 0 && rr < rg) fh[rr * T + o] = rnd<RND>(fmaxf(a + bias, 0.f));
    }
  }
  __syncthreads();
  for (int base = 0; base < 4 * O; base += THREADS) {  // feat = wf2 @ hidden + bf2
    const int o = (base + tid) >> 2, q = tid & 3;
    float wr[T / 4];
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk) wr[kk] = o < O ? rnd<RND>(__ldg(w + off.wf2 + o * T + q + 4 * kk)) : 0.f;
    const float bias = o < O ? __ldg(w + off.bf2 + o) : 0.f;
    float acc[RG] = {};
#pragma unroll
    for (int kk = 0; kk < T / 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) acc[rr] = fmaf(wr[kk], fh[rr * T + q + 4 * kk], acc[rr]);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      float a = acc[rr] + __shfl_xor_sync(0xffffffffu, acc[rr], 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (o < O && q == 0 && rr < rg) out_feat[(size_t)(g0 + rr) * O + o] = a + bias;
    }
  }
}

template <int MODE>
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
  using S = Smem<MODE>;
  constexpr bool RND = MODE == MODE_BF16;  // the node MLPs' operands rounded to bf16
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
  const TileSrc src = tile_src(aj, qj, tj, edge, mask, NP);
  auto prefetch = [&](int it, bool with_bj) {
    const int row = row_lo + it / tiles, tl = it % tiles;
    const int b = row / N;
    prefetch_tile<MODE>(sm, src, b, row - b * N, row, tl, with_bj, tid);
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
  stage_weights<MODE>(sm, LoopW{w + off.whm, w + off.wad, w + off.waq, w + off.ba1, w + off.br1,
                                w + off.bt1, w + off.bl1, w + off.wrq, w + off.w2, w + off.b2}, tid);

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
      node_terms<RND>(w, off, nr, sm + S::AI, sm + S::TN, rg, H, tid);
      __syncthreads();
    }
    const float* ns = sm + S::NS + r * NODE;

    // -- build: hid tile, HID partials, geometry records; a new row's state --
    build_tile<MODE>(sm, sm + S::AI + r * T, ns + N_Q, ns + N_T, nj, tid, warp, lane);
    if (tl == 0 && tid >= 128 && tid < 128 + T) {  // the torsion head's extra term
      sm[S::COEF + 4 * HEADS + 2 * T + tid - 128] = sm[S::TN + r * T + tid - 128];
    } else if (tl == 0 && tid >= 192 && tid < 192 + FOLD) {  // the running fold
      sm[S::FR + tid - 192] = (tid - 192 == F_M) ? -1e30f : 0.f;
    }
    __syncthreads();  // hid, geometry ready; the raw buffers are free

    if (it + 1 < items) {
      const int nrow = row_lo + (it + 1) / tiles, ntl = (it + 1) % tiles;
      prefetch(it + 1, nrow / N != b || ntl != tl);
    }

    tile_product<MODE>(sm, nj, warp, lane);
    __syncthreads();  // lin2 outputs ready

    // -- fold: warps 0-2 fold 32 neighbours each; warps 3-4 sum HID --------
    if (warp < 3) {
      fold_tile<MODE>(sm, nj, warp, lane);
    } else if (warp < 5) {
      const int k = tid - 96;
      if (k < T) sm[S::HS + r * T + k] = hid_sum<MODE>(sm, sm[S::HS + r * T + k], k);
    }
    __syncthreads();

    // -- warp 0: merge the three partials into the row's running state;
    // -- after the row's last tile, its geometry outputs ----------------------
    if (warp == 0) {
      merge_tile<MODE>(sm, lane);
      if (tl + 1 == tiles) row_outputs(sm + S::FR, ns, row, lane, out_q, out_t, out_tors);
    }
    if (tl + 1 < tiles || r + 1 < rg) continue;

    // -- the group's last row is done: its feature MLPs, each weight loaded
    // -- once into registers for all the group's rows -------------------------
    __syncthreads();
    feature_mlp<RND>(w, off, sm + S::NS, sm + S::HS, sm + S::FH, out_feat, g0, rg, H, O, tid);
  }
}

// ---- high mode (--fast-f32): the tile products on wgmma (egnn_high.cuh) ---

using HighSmemF = HighSmem<NODE>;

// The fused layer's row end: the row's geometry outputs.
struct FusedRows {
  float *out_q, *out_t, *out_tors;
  __device__ __forceinline__ void row_done(const float* fr, const float* ns, int row, int lane) const {
    row_outputs(fr, ns, row, lane, out_q, out_t, out_tors);
  }
};

template <>
__global__ void __launch_bounds__(THREADS, 1)
egnn_fused_kernel<MODE_HIGH>(const float* __restrict__ w, const float* __restrict__ h,
                             const float* __restrict__ qi, const float* __restrict__ ti,
                             const float* __restrict__ tors, const float* __restrict__ aj,
                             const float* __restrict__ qj, const float* __restrict__ tj,
                             const float* __restrict__ edge, const float* __restrict__ mask,
                             float* __restrict__ out_q, float* __restrict__ out_t, float* __restrict__ out_tors,
                             float* __restrict__ out_feat, int rows, int per_block, int N, int NP, int H, int O) {
  using S = HighSmemF;
  extern __shared__ __align__(16) float smem[];
  const uint32_t raw_addr = smem_addr(smem);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  char* tb = reinterpret_cast<char*>(smem) + pad;  // 1024-byte aligned
  float* sm = reinterpret_cast<float*>(tb);
  const uint32_t tb_addr = raw_addr + pad;
  const int row_lo = blockIdx.x * per_block;
  const int row_hi = min(rows, row_lo + per_block);
  if (row_lo >= row_hi) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Offsets off = weight_offsets(H, O);
  const int tiles = (NP + TILE - 1) / TILE;
  const int items = (row_hi - row_lo) * tiles;
  const TileSrc src = tile_src(aj, qj, tj, edge, mask, NP);
  PhaseClock clk;
  clk.start();

  if (tid >= PRODUCER) {  // the first item's raw inputs, while the weights are staged
    const int b = row_lo / N;
    prefetch_raw<128>(RawTile{sm + S::AJ, sm + S::ED, sm + S::QJ, sm + S::TJ, sm + S::MK}, src, b, row_lo - b * N,
                      row_lo, 0, true, tid - PRODUCER);
    cp_async_commit();
  }
  stage_high<S>(sm, tb, LoopW{w + off.whm, w + off.wad, w + off.waq, w + off.ba1, w + off.br1, w + off.bt1,
                           w + off.bl1, w + off.wrq, w + off.w2, w + off.b2}, tid);
  fence_proxy_async();  // the staged B tiles, for wgmma's reads

  for (int g0 = row_lo; g0 < row_hi; g0 += RG) {
    const int rg = min(RG, row_hi - g0);
    // -- the row group: node inputs, a_i and the torsion node terms --------
    for (int e = tid; e < rg * NODE; e += THREADS) {
      const int r = e / NODE, k = e - r * NODE;
      const size_t rr = (size_t)(g0 + r);
      float v = 0.f;
      if (k < N_T) v = qi[rr * 4 + k];
      else if (k < N_TOR) v = ti[rr * 3 + k - N_T];
      else if (k < N_TOR + 2 * NTOR) v = tors[rr * 2 * NTOR + k - N_TOR];
      else if (k >= N_H && k < N_H + H) v = h[rr * H + k - N_H];
      sm[S::NS + e] = v;
    }
    for (int e = tid; e < rg * T; e += THREADS) sm[S::HS + e] = 0.f;
    __syncthreads();
    node_terms<false>(w, off, sm + S::NS, sm + S::AI, sm + S::TN, rg, H, tid);
    __syncthreads();

    // -- the group's items: warpgroups 0-1 consume, warpgroup 2 produces ---
    const int it0 = (g0 - row_lo) * tiles;
    clk.mark(11);
    if (tid < PRODUCER) {
      high_consumer<S>(sm, tb_addr, it0, rg * tiles, row_lo, g0, tiles, warp, lane, clk);
    } else {
      high_producer<S>(sm, tb, src, it0, rg * tiles, items, row_lo, g0, N, NP, tiles, warp, lane,
                       FusedRows{out_q, out_t, out_tors}, clk);
    }

    // -- the group's feature MLPs ------------------------------------------
    __syncthreads();
    feature_mlp<false>(w, off, sm + S::NS, sm + S::HS, sm + S::FH, out_feat, g0, rg, H, O, tid);
  }
  clk.mark(11);
}

template <int MODE>
constexpr size_t smem_bytes() {
  if constexpr (MODE == MODE_HIGH) {
    return HighSmemF::BYTES;
  } else {
    return Smem<MODE>::BYTES;
  }
}

template <int MODE>
int launch(const float* w, const float* h, const float* qi, const float* ti, const float* tors,
           const float* aj, const float* qj, const float* tj, const float* edge, const float* mask,
           float* out_q, float* out_t, float* out_tors, float* out_feat,
           int B, int N, int NP, int H, int O, cudaStream_t stream) {
  static std::atomic<int> sms_of[MAX_DEVICES];
  const int sms = persistent_sms(egnn_fused_kernel<MODE>, smem_bytes<MODE>(), sms_of);
  if (sms < 0) return -sms;
  // one block per SM, each a contiguous run of query rows
  int rows = B * N;
  int per_block = (rows + sms - 1) / sms;
  const int grid = (rows + per_block - 1) / per_block;
  void* args[] = {&w, &h, &qi, &ti, &tors, &aj, &qj, &tj, &edge, &mask,
                  &out_q, &out_t, &out_tors, &out_feat, &rows, &per_block, &N, &NP, &H, &O};
  const cudaError_t err = cudaLaunchKernel(egnn_fused_kernel<MODE>, dim3(grid), dim3(THREADS), args,
                                           smem_bytes<MODE>(), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pmhc

extern "C" {

// Length in floats of the packed weight buffer for input width H and
// output width O (the Python packer checks its buffer against it).
int egnn_fused_weights_size(int H, int O) { return pmhc::weight_offsets(H, O).total; }

#ifdef PMHC_FUSED_PHASES
// Copies the high kernel's phase cycle counters ([WARPS][FUSED_NPHASE] unsigned
// 64-bit) to ``out`` and clears them.
int egnn_fused_phases(unsigned long long* out) {
  using namespace pmhc;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_fused_phases, sizeof(g_fused_phases));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[WARPS][FUSED_NPHASE];
  return (int)cudaMemcpyToSymbol(g_fused_phases, zero, sizeof(zero));
}
#endif

int egnn_fused_launch(const float* w, const float* h, const float* qi, const float* ti,
                      const float* tors, const float* aj, const float* qj, const float* tj,
                      const float* edge, const float* mask, float* out_q, float* out_t,
                      float* out_tors, float* out_feat, int B, int N, int NP, int H, int O,
                      int mode, void* stream) {
  using namespace pmhc;
  if (H < 1 || H > T || O < 1 || O > HEADS || B < 1 || N < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_BF16) {
    return launch<MODE_BF16>(w, h, qi, ti, tors, aj, qj, tj, edge, mask, out_q, out_t, out_tors,
                             out_feat, B, N, NP, H, O, s);
  }
  if (mode == MODE_HIGH) {
    return launch<MODE_HIGH>(w, h, qi, ti, tors, aj, qj, tj, edge, mask, out_q, out_t, out_tors,
                             out_feat, B, N, NP, H, O, s);
  }
  if (mode != MODE_FP32) return (int)cudaErrorInvalidValue;
  return launch<MODE_FP32>(w, h, qi, ti, tors, aj, qj, tj, edge, mask, out_q, out_t, out_tors,
                           out_feat, B, N, NP, H, O, s);
}

}  // extern "C"
