// The training layer's neighbour loop for Hopper (sm_90a): a forward and
// a backward kernel, each with an fp32, a bf16 and a high (--fast-f32)
// mode (egnn_common.cuh).
//
// Replaces four TPU kernels of pmhc_tpu/ops/egnn_pallas_lane_vjp.py:
//   forward   _make_loop_fwd (f32, "high"), _make_loop_fwd_g8 (--bf16)
//   backward  _make_loop_bwd (f32, "high"), _make_loop_bwd_g8 (--bf16)
// on the [B, N, C] layout, without the TPU layouts (lane packing,
// component-major 8-groups, selection matmuls, HEADPACK, batch grid).
// Plain PyTorch twin: pmhc_tpu_torch/ops/egnn_loop.py::egnn_loop_plain
// (forward) and autograd through it (backward).
//
// Forward. Per query row (b, i), over its NP neighbours, the recompute of
// egnn_tile.cuh (a_i and the torsion node term come in pre-projected)
// folded into the online-softmax accumulators m, D, GD[4], TA[7], TR[3],
// CNT and the plain sum HID[T] of relu(pre) over all NP slots. It is
// egnn_fused.cu's neighbour loop (the tile loop of egnn_tile.cuh) without
// the node MLPs and the per-node finalize, which stay in torch so autograd
// carries them; the design is described above the kernel
// (egnn_loop_fwd_kernel).
//
// Backward. Takes the cotangents of D, GD, TA, TR, HID (m and CNT carry
// none) and the forward's final m, recomputes each neighbour tile
// (flash-style) and runs the adjoints; the design is described above the
// kernel (egnn_loop_bwd_kernel). Blocks are persistent (one per SM, each a
// contiguous run of rows), so every weight gradient is summed in registers
// or shared memory across all the rows of a block, written once per block
// as a partial, and the partials are summed by a second kernel: no atomics
// and a fixed order for the weight gradients. d(a_j), d(q_j), d(t_j) (over
// the 16 query rows of an entry) and d(edge) (over the batch) are summed
// with fp32 atomics (vector atomics for d(a_j), d(edge)), so their last
// bits vary from run to run.
//
// Bound. Per (b, i, j) pair the forward is ~35 kFLOP (see
// egnn_fused.cu): 3.45 GFLOP per launch at B=64, N=16, NP=96 against ~3.5
// MB, bound by operations (>= ~52 us fp32, >= ~3.5 us bf16; there the
// CUDA-core work around the tensor-core products sets the time). The
// backward recomputes it and adds the whm outer product and whm^T
// d(pre_heads) (2 x 256 x 64 MACs) and the lin2 terms:
// ~100 kFLOP, ~10 GFLOP per launch at B=64, N=16, NP=96 against a few MB:
// bound by operations (>= ~0.15 ms at the H100 SXM's published 67 TFLOP/s
// fp32 peak, >= ~0.01 ms at 989 TFLOP/s bf16; 700 W). fp32: its three
// products are FFMA in register tiles; bf16: they run on the tensor cores,
// and the CUDA-core work around them (recompute epilogues, adjoints, the
// per-unit sums, atomics) sets the time; high: three tensor-core passes
// per product (>= ~0.03 ms), with the splits on the CUDA cores.
//
// bf16 mode: the rounding points of egnn_tile.cuh in the recompute;
// in the backward, the operands of the dW2 and dwhm/dwrq outer products,
// of w2^T d(out), of whm^T d(pre_heads) and of wrq^T d(rot) are rounded
// to bf16 (as the g8 TPU backward rounds its matmul operands). Unlike
// the TPU kernels, the attention's rank-1 terms, the biases and the
// torsion node term enter the recompute in fp32 (the TPU's HEADPACK
// rounds them), and the sums over query rows and over the batch are not
// rounded (the TPU's collapse and d(edge) matmuls round their cotangent
// operand). tests/test_torch_egnn_loop.py measures the difference. The
// backward's bias, wad and waq gradients, d(tor_node), d(a_i) and the sums
// of phase E's attention terms take unrounded d(pre_heads), as the plain
// version's autograd does.
//
// Interface: plain C, loaded with ctypes. Launchers allocate nothing,
// launch on the caller's stream and return the CUDA error code.

#include "egnn_tile.cuh"

#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace pmhc {
namespace {

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

// ---------------------------------------------------------------------------
// Forward. Replaces the TPU kernels _make_loop_fwd (#4, fp32) and
// _make_loop_fwd_g8 (#5, bf16). It is egnn_fused.cu's neighbour loop
// (egnn_tile.cuh) without the node MLPs and the finalize: one persistent
// block of 12 warps per SM over a contiguous run of query rows (8 at
// B=64, N=16: 128 blocks, one wave), the weights staged once per block,
// neighbours in tiles of 96 with the next (row, tile)'s edge, mask, a_i,
// tor_node, q_i and t_i in flight (cp.async) while a tile computes, and
// a_j, q_j, t_j copied only when the batch element or the tile changes.
// Per tile: build (hid, HID partials, geometry), the 12 product tasks
// (bf16: mma.sync; fp32: FFMA register tiles, no TF32), the fold on warps
// 0-2 and HID on warps 3-4, the merge on warp 0; after a row's last tile
// the block writes its m, D, GD, TA, TR, CNT and HID. m is the exact
// maximum of the masked logits from -1e30 (a maximum does not depend on
// the order), as the backward's recompute of exp(logit - m) needs.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_ab.py): fp32 ~0.125 ms,
// bf16 ~0.044 ms per launch at batch 64; the fp32 head product is ~78 %
// of it, bf16 the per-row sequence around a ~15 us product (PERF.md,
// section 6).

// the row's node inputs (cp.async): a_i [T], tor_node [T], q_i [4], t_i [3]
constexpr int L_AI = 0, L_TN = T, L_QI = 2 * T, L_TI = 2 * T + 4, L_NODE = 2 * T + 8;

// Shared memory of the forward, in floats: the tile loop's, then the row's.
template <int MODE>
struct FSmem : TileSmem<MODE> {
  static constexpr int NR = TileSmem<MODE>::END;  // the row's node inputs [L_NODE]
  static constexpr int BT1 = NR + L_NODE;         // bt1 [T]
  static constexpr int HS = BT1 + T;              // the row's HID over its earlier tiles [T]
  static constexpr int TOTAL = HS + T;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
  static_assert(BYTES <= 232448, "forward shared memory exceeds the H100's 227 KB");
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    egnn_loop_fwd_kernel(const Inputs in, const FwdOut out, int per_block) {
  using S = FSmem<MODE>;
  extern __shared__ __align__(16) float smem[];
  float* sm = smem;
  const int rows = in.B * in.N;
  const int row_lo = blockIdx.x * per_block;
  const int row_hi = min(rows, row_lo + per_block);
  if (row_lo >= row_hi) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int N = in.N;
  const int tiles = (in.NP + TILE - 1) / TILE;
  const int items = (row_hi - row_lo) * tiles;

  // -- prefetch of one work item (row, tile), and of the node inputs of
  // -- the row it opens ----------------------------------------------------
  const TileSrc src = tile_src(in.aj, in.qj, in.tj, in.edge, in.mask, in.NP);
  const bool al_ai = (reinterpret_cast<uintptr_t>(in.ai) & 15) == 0;
  const bool al_tn = (reinterpret_cast<uintptr_t>(in.tor) & 15) == 0;
  const bool al_qi = (reinterpret_cast<uintptr_t>(in.qi) & 15) == 0;
  auto prefetch = [&](int it, bool with_bj) {
    const int row = row_lo + it / tiles, tl = it % tiles;
    const int b = row / N;
    prefetch_tile<MODE>(sm, src, b, row - b * N, row, tl, with_bj, tid);
    if (tl == 0) {
      if (tid < T / 4) {
        copy16(sm + S::NR + L_AI + 4 * tid, in.ai + (size_t)row * T + 4 * tid, al_ai);
      } else if (tid < T / 2) {
        copy16(sm + S::NR + L_TN + 4 * (tid - T / 4), in.tor + (size_t)row * T + 4 * (tid - T / 4), al_tn);
      } else if (tid == T / 2) {
        copy16(sm + S::NR + L_QI, in.qi + (size_t)row * 4, al_qi);
      } else if (tid < T / 2 + 4) {
        cp_async4(sm + S::NR + L_TI + tid - T / 2 - 1, in.ti + (size_t)row * 3 + tid - T / 2 - 1);
      }
    }
    cp_async_commit();
  };
  prefetch(0, true);

  // -- the block's resident weights (while the first tile lands) -------------
  stage_weights<MODE>(sm, loop_w(in.w), tid);
  if (tid < T) sm[S::BT1 + tid] = in.w[O_BT1 + tid];

  for (int it = 0; it < items; ++it) {
    const int row = row_lo + it / tiles, tl = it % tiles;
    const int b = row / N;
    const int nj = min(TILE, in.NP - tl * TILE);
    cp_async_wait_all();
    __syncthreads();  // this item's inputs have landed; the last item's merge is done

    // -- build: hid tile, HID partials, geometry records; a new row's state --
    build_tile<MODE>(sm, sm + S::NR + L_AI, sm + S::NR + L_QI, sm + S::NR + L_TI, nj, tid, warp, lane);
    if (tl == 0 && tid >= 128 && tid < 128 + T) {  // the torsion head's extra term: tor_node + bt1
      const int k = tid - 128;
      sm[S::COEF + 4 * HEADS + 2 * T + k] = sm[S::NR + L_TN + k] + sm[S::BT1 + k];
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
    const bool last = tl + 1 == tiles;
    if (warp < 3) {
      fold_tile<MODE>(sm, nj, warp, lane);
    } else if (warp < 5) {
      const int k = tid - 96;
      if (k < T) {
        const float s = hid_sum<MODE>(sm, tl == 0 ? 0.f : sm[S::HS + k], k);
        if (last) {
          out.HID[(size_t)row * T + k] = s;
        } else {
          sm[S::HS + k] = s;
        }
      }
    }
    __syncthreads();

    // -- warp 0: merge the partials; after the row's last tile, its outputs --
    if (warp == 0) {
      const float v = merge_tile<MODE>(sm, lane);
      if (last) {
        if (lane == F_M) {
          out.m[row] = v;
        } else if (lane == F_D) {
          out.D[row] = v;
        } else if (lane < F_TA) {
          out.GD[(size_t)row * 4 + lane - F_GD] = v;
        } else if (lane < F_TR) {
          out.TA[(size_t)row * NTOR + lane - F_TA] = v;
        } else if (lane < F_CNT) {
          out.TR[(size_t)row * 3 + lane - F_TR] = v;
        } else if (lane == F_CNT) {
          out.CNT[row] = v;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. Replaces the TPU kernels _make_loop_bwd (#6, fp32) and
// _make_loop_bwd_g8 (#7, bf16). One persistent block of 12 warps per SM
// over a contiguous run of query rows; the weights are staged once per
// block. Per row, neighbours go in tiles of BT = 48 (NP = 96: two tiles;
// NP <= MAXNP). Per tile, between barriers:
//   S0 build  the hid tile (rows past the tile's neighbours zero; 8- or
//             16-byte loads of a_j and edge where they are aligned, else
//             4-byte), the geometry records (warps 10-11, lane = neighbour);
//   S1        warp w = (16-neighbour block jb, head hd): act = relu(hid @
//             whm^T + extra) for its 16 x 64 (neighbour, unit) tile into DP,
//             and the head's lin2 rows from it;
//   S2 B      warps 8-9, lane = neighbour: the value-path adjoints -> the
//             lin2 outputs' cotangents d(out) [13], d(t_i) into RQL, and
//             d(q_j), d(q_j^-1), d(t_j) over the lane's lin2 output row;
//   S3        the same warp tasks: the dW2 partials (shared memory, one slot
//             per neighbour block, summed over the block's rows); d(act) =
//             w2^T d(out), relu-gated over act in DP to d(pre_heads); the
//             per-neighbour sums over the head units of phase E;
//   P         warps 0-7: dwhm += d(pre_heads)^T @ hid (accumulators in
//             shared memory, each owned by one lane), (fp32) d(hid) of
//             neighbours 32-47, then thread u's sums over the tile's
//             neighbours (bias, wad, waq, wrq grads, d(tor)); warps 8-9:
//             phase F (quaternion and distance adjoints, lane = neighbour,
//             d(q_i) into RQL); warps 8-11: d(hid) of neighbours 0-31 (fp32)
//             or all 48 (bf16). d(hid) = d(pre_heads) @ whm + d(HID),
//             relu-gated: d(a_i) summed per tile into shared memory, d(a_j)
//             and d(edge) by vector atomics. The split evens the work per
//             warp.
// bf16 (template MODE): the products on mma.sync m16n8k16 (bf16 operands,
// fp32 sums): whm as two sets of B fragments (for act and for d(hid)), the
// lin2 forward from act's C fragments, the lin2 backward and dW2 from DP;
// fp32: IEEE FMA in register tiles (no TF32, no tensor cores). high
// (--fast-f32): the bf16 mode's tasks with each product split into three
// mma.sync (mma_split_16816) on the fp32 mode's shared memory (whm, w2 and
// the hid tile in fp32; split fragments of whm twice over would not fit
// in 227 KB beside DW and DP): every fragment is split from fp32 where it
// is loaded, and act stays unrounded in DP.
// The per-element state (q_j, q_j^-1, t_j of the row's batch element) is
// cached for all NP neighbours and rebuilt when a block's run of rows
// crosses into the next batch element.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_ab.py): fp32 ~0.43 ms, bf16
// ~0.23 ms per launch at batch 64; the products and the per-unit sums are
// the largest parts (PERF.md, section 6).

constexpr int BT = 48;                 // neighbours per tile: three 16-row blocks
constexpr int MAXNP = 96;              // neighbours per row the per-element cache holds
constexpr int DP_LD = HEADS + 4;       // act, then d(pre_heads): row stride (floats)
constexpr int HA_LD = T / 2 + 4;       // bf16 hid [j][k] row stride (words)
constexpr int HT_LD = BT / 2 + 4;      // bf16 hid^T [k][j] row stride (words)
constexpr int DV_LD = 14;              // lin2 outputs (then phase B's records) and their cotangents
constexpr int RED_LD = 8;              // d(local quat)[4], wad . d(att), waq . d(att)
constexpr int FR_LD = 12;              // cached per neighbour: q_j[4], q_j^-1[4], t_j[3]
constexpr int F_QJ = 0, F_INV = 4, F_TJ = 8;
constexpr int CT_M = 0, CT_D = 1, CT_GD = 2, CT_TA = 6, CT_TR = 13, CT_N = 16;

// Shared memory of the backward, in floats (every region 16-byte aligned);
// high mode has the fp32 mode's regions (and one d(a_i) slot).
template <int MODE>
struct BSmem {
  static constexpr bool BF16 = MODE == MODE_BF16;
  static constexpr int WHM = 0;   // bf16: B fragments of whm^T [4 heads][8 n][4 k][32] uint2; fp32: whm [HEADS][HF_LD]
  static constexpr int WHT = WHM + (BF16 ? HEADS * T / 2 : HEADS * HF_LD);  // bf16: B fragments of whm [8 n][16 k][32] uint2
  static constexpr int W2F = WHT + (BF16 ? HEADS * T / 2 : 0);   // bf16: lin2 B fragments [4 heads][4 k][32] uint2
  static constexpr int W2T = W2F + (BF16 ? 4 * 4 * 32 * 2 : 0);  // bf16: lin2^T B fragments [4 heads][8 n][32] uint32
  static constexpr int DW = W2T + (BF16 ? 4 * 8 * 32 : 0);       // dwhm accumulators [8 warps][16][32 lanes] float4
  static constexpr int DP = DW + HEADS * T;                       // act (S1 -> S3), then d(pre_heads) [BT][DP_LD]
  static constexpr int HID = DP + BT * DP_LD;                     // bf16: hid [BT][HA_LD] words; fp32 [BT][HF_LD]
  static constexpr int HIDT = HID + BT * (BF16 ? HA_LD : HF_LD);  // bf16: hid^T [T][HT_LD] words
  static constexpr int GEOS = HIDT + (BF16 ? T * HT_LD : 0);      // [BT][GEO_LD]
  static constexpr int OUTS = GEOS + BT * GEO_LD;                 // lin2 outputs, then B's d(q_j), d(q_j^-1), d(t_j) [BT][DV_LD]
  static constexpr int DOUT = OUTS + BT * DV_LD;                  // their cotangents [BT][DV_LD]
  static constexpr int REDS = DOUT + BT * DV_LD;                  // [BT][RED_LD]
  static constexpr int FRM = REDS + BT * RED_LD;                  // the batch element's neighbours [MAXNP][FR_LD]
  static constexpr int AI = FRM + MAXNP * FR_LD;                  // a_i [T]
  static constexpr int GH = AI + T;                               // d(HID) [T]
  static constexpr int TN = GH + T;                               // torsion node term + bt1 [T]
  static constexpr int NODE = TN + T;                             // q_i[4], t_i[3]
  static constexpr int CT = NODE + 8;                             // m and the cotangents [CT_N]
  static constexpr int DAI = CT + CT_N;                           // d(a_i) partials [DAI_SLOTS][T]
  static constexpr int DAI_SLOTS = MODE == MODE_FP32 ? 5 : 1;
  static constexpr int RQL = DAI + DAI_SLOTS * T;                 // d(q_i)[4], d(t_i)[3] per neighbour slot [BT][8]
  static constexpr int DW2 = RQL + BT * 8;                        // dW2 sums [3 neighbour blocks][NOUT][T]
  static constexpr int W2S = DW2 + 3 * NOUT * T;                  // fp32: w2 [NOUT][T]
  static constexpr int TOTAL = W2S + (BF16 ? 0 : NOUT * T);
  static constexpr size_t BYTES = TOTAL * sizeof(float);
  static_assert(BYTES <= 232448, "backward shared memory exceeds the H100's 227 KB");
};

__device__ __forceinline__ float bf_lo(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float bf_hi(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// One halving step of a reduce-scatter over the lanes that differ in lane
// bit BIT: lanes with the bit set keep the upper half of v, summed.
template <int N, int BIT>
__device__ __forceinline__ void rs_step(const float (&v)[N], float (&o)[N / 2], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float keep = up ? v[N / 2 + k] : v[k], send = up ? v[k] : v[N / 2 + k];
    o[k] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

// The extra term's coefficients of head unit u (HEAD = u / T): c0..c3, cb.
template <bool RND, int HEAD>
__device__ __forceinline__ void unit_coef(const LoopW& w, const float* tn, int uu, float* c) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  if constexpr (HEAD == 0) {
    c[0] = __ldg(w.wad + uu);
    c[1] = __ldg(w.waq + uu);
    c[4] = __ldg(w.ba1 + uu);
  } else if constexpr (HEAD == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = rnd<RND>(__ldg(w.wrq + uu * 4 + r));
    c[4] = __ldg(w.br1 + uu);
  } else if constexpr (HEAD == 2) {
    c[4] = tn[uu];
  } else {
    c[4] = __ldg(w.bl1 + uu);
  }
}

// S1, fp32: lane (pg, ug) = (lane / 8, lane % 8) holds neighbours jb + pg + 4q
// (q < 4) x units HEAD * T + ug + 8v (v < 8), in two halves of 4 units (one
// 32-float tile would push the kernel past 168 registers into spills). act =
// relu(hid @ whm^T + extra) goes to DP for S3; the head's lin2 rows go to
// OUTS.
template <int HEAD>
__device__ __forceinline__ void s1_fp32(float* sm, const LoopW& w, int jb, int lane) {
  using S = BSmem<MODE_FP32>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NE = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 1;
  const int pg = lane >> 3, ug = lane & 7;
  const float* hrow = sm + S::HID + (jb + pg) * HF_LD;
  float e[4][NE];
#pragma unroll
  for (int q = 0; q < 4; ++q) pair_operands<HEAD>(sm + S::GEOS, jb + pg + 4 * q, e[q]);
  float part[4 * R];
#pragma unroll
  for (int k = 0; k < 4 * R; ++k) part[k] = 0.f;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {  // units HEAD * T + ug + 8v, v = 4 half + vv
    const float* wrow = sm + S::WHM + (HEAD * T + ug + 32 * half) * HF_LD;
    float act[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int vv = 0; vv < 4; ++vv) act[q][vv] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < T; k0 += 4) {
      float4 x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = ld4(hrow + 4 * q * HF_LD + k0);
#pragma unroll
      for (int vv = 0; vv < 4; ++vv) {
        const float4 wv = ld4(wrow + 8 * vv * HF_LD + k0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          act[q][vv] = fmaf(wv.w, x[q].w, fmaf(wv.z, x[q].z, fmaf(wv.y, x[q].y, fmaf(wv.x, x[q].x, act[q][vv]))));
      }
    }
#pragma unroll
    for (int vv = 0; vv < 4; ++vv) {
      const int uu = ug + 32 * half + 8 * vv;
      float c[5];
      unit_coef<false, HEAD>(w, sm + S::TN, uu, c);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        act[q][vv] = fmaxf(act[q][vv] + extra_term<HEAD>(e[q], c), 0.f);
        sm[S::DP + (jb + pg + 4 * q) * DP_LD + HEAD * T + uu] = act[q][vv];
      }
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const float wv = sm[S::W2S + (R0 + o) * T + uu];
#pragma unroll
        for (int q = 0; q < 4; ++q) part[q * R + o] = fmaf(wv, act[q][vv], part[q * R + o]);
      }
    }
  }
  float h[2 * R], r[R];
  rs_step<4 * R, 4>(part, h, lane);
  rs_step<2 * R, 2>(h, r, lane);
#pragma unroll
  for (int o = 0; o < R; ++o) r[o] += __shfl_xor_sync(0xffffffffu, r[o], 1);
  if (!(lane & 1)) {
    const int q = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
#pragma unroll
    for (int o = 0; o < R; ++o) sm[S::OUTS + (jb + pg + 4 * q) * DV_LD + R0 + o] = r[o] + __ldg(w.b2 + R0 + o);
  }
}

// S3, fp32, the S1 task's lanes: d(pre_heads) = relu'(act) (w2^T d(out)) over
// act in DP; the dW2 partials summed over the lane's neighbours and its 4 pg lanes,
// added to the warp's slot of DW2 (the lane owns rows R0 + o x units ug +
// 8 (2 pg + vv), vv < 2); phase E's sums. d(out) rows past the tile's
// neighbours read as 0: padding carries no gradient into DP, dW2 or the sums.
template <int HEAD>
__device__ __forceinline__ void s3_fp32(float* sm, const LoopW& w, int jb, int nj, int lane, float* dw2) {
  using S = BSmem<MODE_FP32>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  const int pg = lane >> 3, ug = lane & 7;
  float act[4][8], dp[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) act[q][v] = sm[S::DP + (jb + pg + 4 * q) * DP_LD + HEAD * T + ug + 8 * v];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < 8; ++v) dp[q][v] = 0.f;
#pragma unroll
  for (int o = 0; o < R; ++o) {
    float d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = jb + pg + 4 * q;
      d[q] = j < nj ? sm[S::DOUT + j * DV_LD + R0 + o] : 0.f;
    }
    float p[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float wv = sm[S::W2S + (R0 + o) * T + ug + 8 * v];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s = fmaf(d[q], act[q][v], s);
        dp[q][v] = fmaf(wv, d[q], dp[q][v]);
      }
      p[v] = s;
    }
    float h[4], r[2];
    rs_step<8, 16>(p, h, lane);
    rs_step<4, 8>(h, r, lane);
    dw2[(R0 + o) * T + ug + 16 * pg] += r[0];
    dw2[(R0 + o) * T + ug + 16 * pg + 8] += r[1];
  }
  // E: per neighbour, sums over the head's units (attention: wad, waq;
  // rotation: wrq^T d(rot)), over the lane's 8 units and its 8 ug lanes
  constexpr int NS = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 0;
  float ev[4 * NS + 1];
#pragma unroll
  for (int k = 0; k < 4 * NS; ++k) ev[k] = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int uu = ug + 8 * v;
    float cs[NS + 1];
    if constexpr (HEAD == 0) {
      cs[0] = __ldg(w.wad + uu);
      cs[1] = __ldg(w.waq + uu);
    } else if constexpr (HEAD == 1) {
#pragma unroll
      for (int s = 0; s < NS; ++s) cs[s] = __ldg(w.wrq + uu * 4 + s);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = act[q][v] > 0.f ? dp[q][v] : 0.f;
      sm[S::DP + (jb + pg + 4 * q) * DP_LD + HEAD * T + uu] = x;
#pragma unroll
      for (int s = 0; s < NS; ++s) ev[q * NS + s] = fmaf(cs[s], x, ev[q * NS + s]);
    }
  }
  if constexpr (NS > 0) {
    float h1[2 * NS], h2[NS], h3[NS / 2];
    rs_step<4 * NS, 4>(reinterpret_cast<float(&)[4 * NS]>(ev), h1, lane);
    rs_step<2 * NS, 2>(h1, h2, lane);
    rs_step<NS, 1>(h2, h3, lane);
    const int blk = lane & 7;  // index block (NS / 2 values) of ev this lane holds
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) {
      const int f = blk * (NS / 2) + k, q = f / NS, s = f % NS;
      sm[S::REDS + (jb + pg + 4 * q) * RED_LD + (HEAD == 0 ? 4 + s : s)] = h3[k];
    }
  }
}

// S1, bf16: one m16 tile (neighbours jb .. jb + 15) x the 64 units of HEAD on
// the tensor cores (g = lane / 4, c = lane % 4). act (rounded) goes to DP for
// S3, and its C fragments are the lin2's A fragments (units 16t .. 16t +
// 15); the lin2 rows go to OUTS.
template <int HEAD>
__device__ __forceinline__ void s1_bf16(float* sm, const LoopW& w, int jb, int lane) {
  using S = BSmem<MODE_BF16>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NE = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 1;
  const int g = lane >> 2, c = lane & 3;
  const uint32_t* hid = reinterpret_cast<const uint32_t*>(sm + S::HID);
  const uint2* whf = reinterpret_cast<const uint2*>(sm + S::WHM);
  const uint2* w2f = reinterpret_cast<const uint2*>(sm + S::W2F) + HEAD * 4 * 32 + lane;
  const int j = jb + g;
  uint32_t a[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = hid[j * HA_LD + ks * 8 + c];
    a[ks][1] = hid[(j + 8) * HA_LD + ks * 8 + c];
    a[ks][2] = hid[j * HA_LD + ks * 8 + 4 + c];
    a[ks][3] = hid[(j + 8) * HA_LD + ks * 8 + 4 + c];
  }
  float e[2][NE];
  pair_operands<HEAD>(sm + S::GEOS, j, e[0]);
  pair_operands<HEAD>(sm + S::GEOS, j + 8, e[1]);
  float lacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {
    uint32_t la[4];
    float cc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const uint2 bv = whf[((HEAD * 8 + 2 * t + nn) * 4 + ks) * 32 + lane];
        const uint32_t b[2] = {bv.x, bv.y};
        mma_bf16_16816(cc[nn], a[ks], b);
      }
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int uu = 16 * t + 8 * nn + 2 * c;
      float c0[5], c1[5];
      unit_coef<true, HEAD>(w, sm + S::TN, uu, c0);
      unit_coef<true, HEAD>(w, sm + S::TN, uu + 1, c1);
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const float x0 = fmaxf(cc[nn][2 * h8] + extra_term<HEAD>(e[h8], c0), 0.f);
        const float x1 = fmaxf(cc[nn][2 * h8 + 1] + extra_term<HEAD>(e[h8], c1), 0.f);
        const uint32_t pk = pack_bf16x2(x0, x1);
        la[2 * nn + h8] = pk;
        *reinterpret_cast<float2*>(sm + S::DP + (j + 8 * h8) * DP_LD + HEAD * T + uu) =
            float2{bf_lo(pk), bf_hi(pk)};
      }
    }
    const uint2 wv = w2f[t * 32];
    const uint32_t b2[2] = {wv.x, wv.y};
    mma_bf16_16816(lacc, la, b2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = 2 * c + r;
    if (n < R) {
      const float bias = __ldg(w.b2 + R0 + n);
      sm[S::OUTS + j * DV_LD + R0 + n] = lacc[r] + bias;
      sm[S::OUTS + (j + 8) * DV_LD + R0 + n] = lacc[2 + r] + bias;
    }
  }
}

// S3, bf16, on the tensor cores: dW2 += d(out)^T @ act into the warp's slot
// of DW2 (the lane owns rows R0 + g x units 8nt + 2c + r); d(act) = d(out) @
// w2, relu-gated by act, over act in DP; phase E's sums. d(out) rows past
// the tile's neighbours read as 0: padding carries no gradient into DP, dW2
// or the sums.
template <int HEAD>
__device__ __forceinline__ void s3_bf16(float* sm, const LoopW& w, int jb, int nj, int lane, float* dw2) {
  using S = BSmem<MODE_BF16>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NS = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 0;
  const int g = lane >> 2, c = lane & 3;
  const int ja = jb + g, jc = jb + g + 8;
  auto dv = [&](int j, int o) { return j < nj && o < R ? sm[S::DOUT + j * DV_LD + R0 + o] : 0.f; };
  // act (from S1, in DP) at (row g | g + 8, unit 8nt + 2c + e): av[nt][2 h8 + e]
  float av[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float* src = sm + S::DP + HEAD * T + 8 * nt + 2 * c;
    const float2 x0 = *reinterpret_cast<const float2*>(src + ja * DP_LD);
    const float2 x1 = *reinterpret_cast<const float2*>(src + jc * DP_LD);
    av[nt][0] = x0.x, av[nt][1] = x0.y, av[nt][2] = x1.x, av[nt][3] = x1.y;
  }
  // dW2[R0 + o][unit] += d(out)^T @ act over the warp's 16 neighbours on the
  // tensor cores: A rows = lin2 rows o (g < R), k = neighbours; B = act (k =
  // neighbours, n = units) from DP, read before this warp overwrites it
  {
    const uint32_t ad[4] = {pack_bf16x2(dv(jb + 2 * c, g), dv(jb + 2 * c + 1, g)), 0u,
                            pack_bf16x2(dv(jb + 2 * c + 8, g), dv(jb + 2 * c + 9, g)), 0u};
    const float* ar = sm + S::DP + (jb + 2 * c) * DP_LD + HEAD * T + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* r = ar + 8 * nt;
      const uint32_t b[2] = {pack_bf16x2(r[0], r[DP_LD]), pack_bf16x2(r[8 * DP_LD], r[9 * DP_LD])};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16_16816(acc, ad, b);
      if (g < R) {
        dw2[(R0 + g) * T + 8 * nt + 2 * c] += acc[0];
        dw2[(R0 + g) * T + 8 * nt + 2 * c + 1] += acc[1];
      }
    }
    __syncwarp();
  }
  const uint32_t a[4] = {pack_bf16x2(dv(ja, 2 * c), dv(ja, 2 * c + 1)),
                         pack_bf16x2(dv(jc, 2 * c), dv(jc, 2 * c + 1)), 0u, 0u};
  const uint32_t* w2t = reinterpret_cast<const uint32_t*>(sm + S::W2T) + HEAD * 8 * 32 + lane;
  float ev[2 * NS + 1];
#pragma unroll
  for (int k = 0; k < 2 * NS; ++k) ev[k] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t b[2] = {w2t[nt * 32], 0u};
    mma_bf16_16816(acc, a, b);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = av[nt][k] > 0.f ? acc[k] : 0.f;
    float* dst = sm + S::DP + HEAD * T + 8 * nt + 2 * c;
    *reinterpret_cast<float2*>(dst + ja * DP_LD) = float2{acc[0], acc[1]};
    *reinterpret_cast<float2*>(dst + jc * DP_LD) = float2{acc[2], acc[3]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int uu = 8 * nt + 2 * c + e;
      float cs[NS + 1];
      if constexpr (HEAD == 0) {
        cs[0] = __ldg(w.wad + uu);
        cs[1] = __ldg(w.waq + uu);
      } else if constexpr (HEAD == 1) {
#pragma unroll
        for (int s = 0; s < NS; ++s) cs[s] = rnd<true>(__ldg(w.wrq + uu * 4 + s));
      }
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const float x = HEAD == 1 ? rnd<true>(acc[2 * h8 + e]) : acc[2 * h8 + e];
#pragma unroll
        for (int s = 0; s < NS; ++s) ev[h8 * NS + s] = fmaf(cs[s], x, ev[h8 * NS + s]);
      }
    }
  }
  if constexpr (NS > 0) {
    float h1[NS], h2[NS / 2];
    rs_step<2 * NS, 2>(reinterpret_cast<float(&)[2 * NS]>(ev), h1, lane);
    rs_step<NS, 1>(h1, h2, lane);
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) {
      const int f = c * (NS / 2) + k, h8 = f / NS, s = f % NS;
      sm[S::REDS + (h8 ? jc : ja) * RED_LD + (HEAD == 0 ? 4 + s : s)] = h2[k];
    }
  }
}

// P, warps 0-7, fp32: dwhm += d(pre_heads)^T @ hid over the tile. Lane (ua,
// cb) = (lane / 8, lane % 8) of warp w owns units 32w + 4ua + a and 32w + 16
// + 4ua + a (a < 4) x columns 4cb + k and 32 + 4cb + k (k < 4): 64 sums kept
// in DW as 16 float4 (slot 2a' + h: unit index a' < 8, column half h).
__device__ __forceinline__ void p3_fp32(float* sm, int warp, int lane) {
  using S = BSmem<MODE_FP32>;
  const int ua = lane >> 3, cb = lane & 7;
  float4* dw = reinterpret_cast<float4*>(sm + S::DW) + warp * 16 * 32 + lane;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float4 l = dw[(2 * a) * 32], h = dw[(2 * a + 1) * 32];
    acc[a][0] = l.x, acc[a][1] = l.y, acc[a][2] = l.z, acc[a][3] = l.w;
    acc[a][4] = h.x, acc[a][5] = h.y, acc[a][6] = h.z, acc[a][7] = h.w;
  }
  const float* dp = sm + S::DP + 32 * warp + 4 * ua;
  const float* hd = sm + S::HID + 4 * cb;
#pragma unroll 2
  for (int j = 0; j < BT; ++j) {
    const float4 d0 = ld4(dp + j * DP_LD), d1 = ld4(dp + j * DP_LD + 16);
    const float4 h0 = ld4(hd + j * HF_LD), h1 = ld4(hd + j * HF_LD + 32);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[a][k] = fmaf(dv[a], hv[k], acc[a][k]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    dw[(2 * a) * 32] = float4{acc[a][0], acc[a][1], acc[a][2], acc[a][3]};
    dw[(2 * a + 1) * 32] = float4{acc[a][4], acc[a][5], acc[a][6], acc[a][7]};
  }
}

// P, warps 0-7, bf16: the same product on the tensor cores. Warp w owns the
// m16 tiles of units 32w .. 32w + 31 (A = d(pre_heads)^T, k = neighbours,
// 3 k-steps) x the 8 n-tiles of columns (B = hid^T fragments): its C
// fragments are kept in DW, slot mt * 8 + nt.
__device__ __forceinline__ void p3_bf16(float* sm, int warp, int lane) {
  using S = BSmem<MODE_BF16>;
  const int g = lane >> 2, c = lane & 3;
  const float* dp = sm + S::DP;
  const uint32_t* ht = reinterpret_cast<const uint32_t*>(sm + S::HIDT);
  uint32_t a[2][3][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int u = 32 * warp + 16 * mt + g;
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const float* r = dp + (16 * ks + 2 * c) * DP_LD + u;
      a[mt][ks][0] = pack_bf16x2(r[0], r[DP_LD]);
      a[mt][ks][1] = pack_bf16x2(r[8], r[DP_LD + 8]);
      a[mt][ks][2] = pack_bf16x2(r[8 * DP_LD], r[9 * DP_LD]);
      a[mt][ks][3] = pack_bf16x2(r[8 * DP_LD + 8], r[9 * DP_LD + 8]);
    }
  }
  float4* dw = reinterpret_cast<float4*>(sm + S::DW) + warp * 16 * 32 + lane;
#pragma unroll 2
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t b[3][2];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      b[ks][0] = ht[(8 * nt + g) * HT_LD + 8 * ks + c];
      b[ks][1] = ht[(8 * nt + g) * HT_LD + 8 * ks + 4 + c];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float4 v = dw[(mt * 8 + nt) * 32];
      float acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) mma_bf16_16816(acc, a[mt][ks], b[ks]);
      dw[(mt * 8 + nt) * 32] = float4{acc[0], acc[1], acc[2], acc[3]};
    }
  }
}

// The relu-gated d(pre) of one neighbour and 4 (fp32) or 2 (bf16)
// consecutive columns of d(hid): summed into d(a_i) (registers), d(a_j) and
// d(edge) by vector atomics (sm_90; the wrapper's fresh outputs and the
// column offsets keep them 16- / 8-byte aligned).
__device__ __forceinline__ void dpre_out4(const BwdIO& io, size_t aj_at, size_t edge_at, float4 v,
                                          float (&dai)[4]) {
  dai[0] += v.x;
  dai[1] += v.y;
  dai[2] += v.z;
  dai[3] += v.w;
  atomicAdd(reinterpret_cast<float4*>(io.daj + aj_at), v);
  atomicAdd(reinterpret_cast<float4*>(io.dedge + edge_at), v);
}

__device__ __forceinline__ void dpre_out2(const BwdIO& io, size_t aj_at, size_t edge_at, float2 v,
                                          float& dai0, float& dai1) {
  dai0 += v.x;
  dai1 += v.y;
  atomicAdd(reinterpret_cast<float2*>(io.daj + aj_at), v);
  atomicAdd(reinterpret_cast<float2*>(io.dedge + edge_at), v);
}

// P, d(hid) = d(pre_heads) @ whm + d(HID), relu-gated. fp32: in two parts
// that even out the FMA per warp with dwhm: warps 8-11 take neighbours
// 0-31, warps 0-7 (after dwhm) neighbours 32-47. bf16: warps 8-11 take all
// (the tensor cores make it short; warps 0-7 carry the per-unit sums).
// dai[k] sums the lane's columns over its neighbours.
//
// fp32, warps 8-11: lane (nq, cg) = (lane / 16 + 2 (warp - 8), lane % 16):
// neighbours nq + 8q (q < 4) x columns 4cg + k.
__device__ __forceinline__ void p2a_fp32(const float* sm, const BwdIO& io, size_t aj0, size_t ed0,
                                         int nj, int warp, int lane, float (&dai)[4]) {
  using S = BSmem<MODE_FP32>;
  const int nq = (lane >> 4) + 2 * (warp - 8), col = 4 * (lane & 15);
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
  const float* dp = sm + S::DP + nq * DP_LD;
  const float* wc = sm + S::WHM + col;
#pragma unroll 2
  for (int k0 = 0; k0 < HEADS; k0 += 4) {
    float4 x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = ld4(dp + 8 * q * DP_LD + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = ld4(wc + (k0 + kk) * HF_LD);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = comp(x[q], kk);
        acc[q][0] = fmaf(wv.x, xv, acc[q][0]);
        acc[q][1] = fmaf(wv.y, xv, acc[q][1]);
        acc[q][2] = fmaf(wv.z, xv, acc[q][2]);
        acc[q][3] = fmaf(wv.w, xv, acc[q][3]);
      }
    }
  }
  const float4 gh = ld4(sm + S::GH + col);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = nq + 8 * q;
    if (j < nj) {
      const float4 h = ld4(sm + S::HID + j * HF_LD + col);
      const float4 v = {h.x > 0.f ? acc[q][0] + gh.x : 0.f, h.y > 0.f ? acc[q][1] + gh.y : 0.f,
                        h.z > 0.f ? acc[q][2] + gh.z : 0.f, h.w > 0.f ? acc[q][3] + gh.w : 0.f};
      const size_t at = (size_t)j * T + col;
      dpre_out4(io, aj0 + at, ed0 + at, v, dai);
    }
  }
}

// fp32, warps 0-7: lane (n, h) = (lane / 2, lane % 2): neighbour 32 + n x
// columns 8 warp + 4h + k.
__device__ __forceinline__ void p2b_fp32(const float* sm, const BwdIO& io, size_t aj0, size_t ed0,
                                         int nj, int warp, int lane, float (&dai)[4]) {
  using S = BSmem<MODE_FP32>;
  const int j = 32 + (lane >> 1), col = 8 * warp + 4 * (lane & 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* dp = sm + S::DP + j * DP_LD;
  const float* wc = sm + S::WHM + col;
#pragma unroll 4
  for (int k0 = 0; k0 < HEADS; k0 += 4) {
    const float4 x = ld4(dp + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = ld4(wc + (k0 + kk) * HF_LD);
      const float xv = comp(x, kk);
      acc[0] = fmaf(wv.x, xv, acc[0]);
      acc[1] = fmaf(wv.y, xv, acc[1]);
      acc[2] = fmaf(wv.z, xv, acc[2]);
      acc[3] = fmaf(wv.w, xv, acc[3]);
    }
  }
  if (j < nj) {
    const float4 gh = ld4(sm + S::GH + col);
    const float4 h = ld4(sm + S::HID + j * HF_LD + col);
    const float4 v = {h.x > 0.f ? acc[0] + gh.x : 0.f, h.y > 0.f ? acc[1] + gh.y : 0.f,
                      h.z > 0.f ? acc[2] + gh.z : 0.f, h.w > 0.f ? acc[3] + gh.w : 0.f};
    const size_t at = (size_t)j * T + col;
    dpre_out4(io, aj0 + at, ed0 + at, v, dai);
  }
}

// bf16, on the tensor cores (A = d(pre_heads) rounded from DP, B = whm
// fragments WHT, k = 256 units): MT m-tiles from m-tile mt0 x NN n-tiles
// from n-tile nt0. dai[2 nn + r] sums column 8 (nt0 + nn) + 2c + r.
template <int MT, int NN>
__device__ __forceinline__ void p2_bf16(const float* sm, const BwdIO& io, size_t aj0, size_t ed0,
                                        int nj, int mt0, int nt0, int lane, float (&dai)[4]) {
  using S = BSmem<MODE_BF16>;
  const int g = lane >> 2, c = lane & 3;
  float acc[MT][NN][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) acc[m][nn][0] = acc[m][nn][1] = acc[m][nn][2] = acc[m][nn][3] = 0.f;
  const uint2* wht = reinterpret_cast<const uint2*>(sm + S::WHT) + lane;
#pragma unroll 2
  for (int ks = 0; ks < HEADS / 16; ++ks) {
    uint32_t b[NN][2];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      const uint2 bv = wht[((nt0 + nn) * 16 + ks) * 32];
      b[nn][0] = bv.x;
      b[nn][1] = bv.y;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* r0 = sm + S::DP + (16 * (mt0 + m) + g) * DP_LD + 16 * ks + 2 * c;
      const float* r1 = r0 + 8 * DP_LD;
      const float2 x00 = *reinterpret_cast<const float2*>(r0), x10 = *reinterpret_cast<const float2*>(r1);
      const float2 x01 = *reinterpret_cast<const float2*>(r0 + 8), x11 = *reinterpret_cast<const float2*>(r1 + 8);
      const uint32_t a[4] = {pack_bf16x2(x00.x, x00.y), pack_bf16x2(x10.x, x10.y),
                             pack_bf16x2(x01.x, x01.y), pack_bf16x2(x11.x, x11.y)};
#pragma unroll
      for (int nn = 0; nn < NN; ++nn) mma_bf16_16816(acc[m][nn], a, b[nn]);
    }
  }
  const uint32_t* ha = reinterpret_cast<const uint32_t*>(sm + S::HID);
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    const int col = 8 * (nt0 + nn) + 2 * c;
    const float gh0 = sm[S::GH + col], gh1 = sm[S::GH + col + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int j = 16 * (mt0 + m) + g + 8 * h8;
        if (j < nj) {
          const uint32_t hw = ha[j * HA_LD + col / 2];
          const float d0 = bf_lo(hw) > 0.f ? acc[m][nn][2 * h8] + gh0 : 0.f;
          const float d1 = bf_hi(hw) > 0.f ? acc[m][nn][2 * h8 + 1] + gh1 : 0.f;
          const size_t at = (size_t)j * T + col;
          dpre_out2(io, aj0 + at, ed0 + at, float2{d0, d1}, dai[2 * nn], dai[2 * nn + 1]);
        }
      }
    }
  }
}

// A fragment (hi, lo) split from a row-major fp32 tile, p = &tile[g][2c]:
// rows g and g + 8 (ld floats apart), columns 2c, 2c + 1 and 2c + 8, 2c + 9.
__device__ __forceinline__ void split_a(const float* p, int ld, uint32_t (&h)[4], uint32_t (&l)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(p), x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8), x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  split_bf16x2(x0.x, x0.y, h[0], l[0]);
  split_bf16x2(x1.x, x1.y, h[1], l[1]);
  split_bf16x2(x2.x, x2.y, h[2], l[2]);
  split_bf16x2(x3.x, x3.y, h[3], l[3]);
}

// B fragment (hi, lo) of column n = g split from an fp32 row that holds k
// contiguously, p = &row[2c]: k = 2c, 2c + 1 and 2c + 8, 2c + 9.
__device__ __forceinline__ void split_b(const float* p, uint32_t (&h)[2], uint32_t (&l)[2]) {
  const float2 x0 = *reinterpret_cast<const float2*>(p), x1 = *reinterpret_cast<const float2*>(p + 8);
  split_bf16x2(x0.x, x0.y, h[0], l[0]);
  split_bf16x2(x1.x, x1.y, h[1], l[1]);
}

// The same where k runs down a column, ld floats apart: p = &col[2c * ld].
__device__ __forceinline__ void split_b_col(const float* p, int ld, uint32_t (&h)[2], uint32_t (&l)[2]) {
  split_bf16x2(p[0], p[ld], h[0], l[0]);
  split_bf16x2(p[8 * ld], p[9 * ld], h[1], l[1]);
}

// S1, high: s1_bf16's tile with each product split (hid and whm from the
// fp32 tile and rows, split per k-step; act and the lin2 rows); act goes
// to DP unrounded.
template <int HEAD>
__device__ __forceinline__ void s1_high(float* sm, const LoopW& w, int jb, int lane) {
  using S = BSmem<MODE_HIGH>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NE = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 1;
  const int g = lane >> 2, c = lane & 3;
  const int j = jb + g;
  float e[2][NE];
  pair_operands<HEAD>(sm + S::GEOS, j, e[0]);
  pair_operands<HEAD>(sm + S::GEOS, j + 8, e[1]);
  float lacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {
    float cc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4];
      split_a(sm + S::HID + j * HF_LD + 16 * ks + 2 * c, HF_LD, ah, al);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t bh[2], bl[2];
        split_b(sm + S::WHM + (HEAD * T + 16 * t + 8 * nn + g) * HF_LD + 16 * ks + 2 * c, bh, bl);
        mma_split_16816(cc[nn], ah, al, bh, bl);
      }
    }
    uint32_t lh[4], ll[4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int uu = 16 * t + 8 * nn + 2 * c;
      float c0[5], c1[5];
      unit_coef<false, HEAD>(w, sm + S::TN, uu, c0);
      unit_coef<false, HEAD>(w, sm + S::TN, uu + 1, c1);
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const float x0 = fmaxf(cc[nn][2 * h8] + extra_term<HEAD>(e[h8], c0), 0.f);
        const float x1 = fmaxf(cc[nn][2 * h8 + 1] + extra_term<HEAD>(e[h8], c1), 0.f);
        split_bf16x2(x0, x1, lh[2 * nn + h8], ll[2 * nn + h8]);
        *reinterpret_cast<float2*>(sm + S::DP + (j + 8 * h8) * DP_LD + HEAD * T + uu) = float2{x0, x1};
      }
    }
    uint32_t bh[2] = {0u, 0u}, bl[2] = {0u, 0u};  // the head's lin2 rows, padded to n = 8 with zeros
    if (g < R) split_b(sm + S::W2S + (R0 + g) * T + 16 * t + 2 * c, bh, bl);
    mma_split_16816(lacc, lh, ll, bh, bl);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = 2 * c + r;
    if (n < R) {
      const float bias = __ldg(w.b2 + R0 + n);
      sm[S::OUTS + j * DV_LD + R0 + n] = lacc[r] + bias;
      sm[S::OUTS + (j + 8) * DV_LD + R0 + n] = lacc[2 + r] + bias;
    }
  }
}

// S3, high: s3_bf16 with each product split (d(out), act from DP, w2 from
// W2S); phase E's sums take d(rot) and wrq unrounded.
template <int HEAD>
__device__ __forceinline__ void s3_high(float* sm, const LoopW& w, int jb, int nj, int lane, float* dw2) {
  using S = BSmem<MODE_HIGH>;
  constexpr int R = rows_of(HEAD), R0 = row0_of(HEAD);
  constexpr int NS = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 0;
  const int g = lane >> 2, c = lane & 3;
  const int ja = jb + g, jc = jb + g + 8;
  auto dv = [&](int j, int o) { return j < nj && o < R ? sm[S::DOUT + j * DV_LD + R0 + o] : 0.f; };
  float av[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float* src = sm + S::DP + HEAD * T + 8 * nt + 2 * c;
    const float2 x0 = *reinterpret_cast<const float2*>(src + ja * DP_LD);
    const float2 x1 = *reinterpret_cast<const float2*>(src + jc * DP_LD);
    av[nt][0] = x0.x, av[nt][1] = x0.y, av[nt][2] = x1.x, av[nt][3] = x1.y;
  }
  {  // dW2[R0 + o][unit] += d(out)^T @ act (A rows = lin2 rows, k = neighbours)
    uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
    split_bf16x2(dv(jb + 2 * c, g), dv(jb + 2 * c + 1, g), ah[0], al[0]);
    split_bf16x2(dv(jb + 2 * c + 8, g), dv(jb + 2 * c + 9, g), ah[2], al[2]);
    const float* ar = sm + S::DP + (jb + 2 * c) * DP_LD + HEAD * T + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bh[2], bl[2];
      split_b_col(ar + 8 * nt, DP_LD, bh, bl);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_split_16816(acc, ah, al, bh, bl);
      if (g < R) {
        dw2[(R0 + g) * T + 8 * nt + 2 * c] += acc[0];
        dw2[(R0 + g) * T + 8 * nt + 2 * c + 1] += acc[1];
      }
    }
    __syncwarp();
  }
  uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
  split_bf16x2(dv(ja, 2 * c), dv(ja, 2 * c + 1), ah[0], al[0]);
  split_bf16x2(dv(jc, 2 * c), dv(jc, 2 * c + 1), ah[1], al[1]);
  const float* w2r = sm + S::W2S + R0 * T;
  float ev[2 * NS + 1];
#pragma unroll
  for (int k = 0; k < 2 * NS; ++k) ev[k] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int un = 8 * nt + g, o = 2 * c;  // B[k = lin2 row][n = unit], k >= R zero
    uint32_t bh[2] = {0u, 0u}, bl[2] = {0u, 0u};
    split_bf16x2(o < R ? w2r[o * T + un] : 0.f, o + 1 < R ? w2r[(o + 1) * T + un] : 0.f, bh[0], bl[0]);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    mma_split_16816(acc, ah, al, bh, bl);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = av[nt][k] > 0.f ? acc[k] : 0.f;
    float* dst = sm + S::DP + HEAD * T + 8 * nt + 2 * c;
    *reinterpret_cast<float2*>(dst + ja * DP_LD) = float2{acc[0], acc[1]};
    *reinterpret_cast<float2*>(dst + jc * DP_LD) = float2{acc[2], acc[3]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int uu = 8 * nt + 2 * c + e;
      float cs[NS + 1];
      if constexpr (HEAD == 0) {
        cs[0] = __ldg(w.wad + uu);
        cs[1] = __ldg(w.waq + uu);
      } else if constexpr (HEAD == 1) {
#pragma unroll
        for (int s = 0; s < NS; ++s) cs[s] = __ldg(w.wrq + uu * 4 + s);
      }
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8)
#pragma unroll
        for (int s = 0; s < NS; ++s) ev[h8 * NS + s] = fmaf(cs[s], acc[2 * h8 + e], ev[h8 * NS + s]);
    }
  }
  if constexpr (NS > 0) {
    float h1[NS], h2[NS / 2];
    rs_step<2 * NS, 2>(reinterpret_cast<float(&)[2 * NS]>(ev), h1, lane);
    rs_step<NS, 1>(h1, h2, lane);
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) {
      const int f = c * (NS / 2) + k, h8 = f / NS, s = f % NS;
      sm[S::REDS + (h8 ? jc : ja) * RED_LD + (HEAD == 0 ? 4 + s : s)] = h2[k];
    }
  }
}

// P, warps 0-7, high: p3_bf16 with each product split (d(pre_heads) from
// DP, hid^T from the fp32 hid tile); the same C fragment slots in DW.
__device__ __forceinline__ void p3_high(float* sm, int warp, int lane) {
  using S = BSmem<MODE_HIGH>;
  const int g = lane >> 2, c = lane & 3;
  uint32_t ah[2][3][4], al[2][3][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const float* r = sm + S::DP + (16 * ks + 2 * c) * DP_LD + 32 * warp + 16 * mt + g;
      split_bf16x2(r[0], r[DP_LD], ah[mt][ks][0], al[mt][ks][0]);
      split_bf16x2(r[8], r[DP_LD + 8], ah[mt][ks][1], al[mt][ks][1]);
      split_bf16x2(r[8 * DP_LD], r[9 * DP_LD], ah[mt][ks][2], al[mt][ks][2]);
      split_bf16x2(r[8 * DP_LD + 8], r[9 * DP_LD + 8], ah[mt][ks][3], al[mt][ks][3]);
    }
  float4* dw = reinterpret_cast<float4*>(sm + S::DW) + warp * 16 * 32 + lane;
#pragma unroll 2
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t bh[3][2], bl[3][2];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
      split_b_col(sm + S::HID + (16 * ks + 2 * c) * HF_LD + 8 * nt + g, HF_LD, bh[ks], bl[ks]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float4 v = dw[(mt * 8 + nt) * 32];
      float acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) mma_split_16816(acc, ah[mt][ks], al[mt][ks], bh[ks], bl[ks]);
      dw[(mt * 8 + nt) * 32] = float4{acc[0], acc[1], acc[2], acc[3]};
    }
  }
}

// P, d(hid), high: p2_bf16 with each product split (d(pre_heads) from DP,
// whm from its fp32 rows, k = units down a column), relu-gated by the fp32
// hid tile.
template <int MT, int NN>
__device__ __forceinline__ void p2_high(const float* sm, const BwdIO& io, size_t aj0, size_t ed0,
                                        int nj, int mt0, int nt0, int lane, float (&dai)[4]) {
  using S = BSmem<MODE_HIGH>;
  const int g = lane >> 2, c = lane & 3;
  float acc[MT][NN][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) acc[m][nn][0] = acc[m][nn][1] = acc[m][nn][2] = acc[m][nn][3] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < HEADS / 16; ++ks) {
    uint32_t bh[NN][2], bl[NN][2];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
      split_b_col(sm + S::WHM + (16 * ks + 2 * c) * HF_LD + 8 * (nt0 + nn) + g, HF_LD, bh[nn], bl[nn]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t ah[4], al[4];
      split_a(sm + S::DP + (16 * (mt0 + m) + g) * DP_LD + 16 * ks + 2 * c, DP_LD, ah, al);
#pragma unroll
      for (int nn = 0; nn < NN; ++nn) mma_split_16816(acc[m][nn], ah, al, bh[nn], bl[nn]);
    }
  }
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    const int col = 8 * (nt0 + nn) + 2 * c;
    const float gh0 = sm[S::GH + col], gh1 = sm[S::GH + col + 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int j = 16 * (mt0 + m) + g + 8 * h8;
        if (j < nj) {
          const float2 hv = *reinterpret_cast<const float2*>(sm + S::HID + j * HF_LD + col);
          const float d0 = hv.x > 0.f ? acc[m][nn][2 * h8] + gh0 : 0.f;
          const float d1 = hv.y > 0.f ? acc[m][nn][2 * h8 + 1] + gh1 : 0.f;
          const size_t at = (size_t)j * T + col;
          dpre_out2(io, aj0 + at, ed0 + at, float2{d0, d1}, dai[2 * nn], dai[2 * nn + 1]);
        }
      }
    }
  }
}

// Built with -DPMHC_LOOP_PHASES (chip_ab.py --phases) the backward adds up,
// per warp and phase, the cycles from the phase's start to the warp's
// arrival at the phase's closing barrier (row [warp]), and on thread 0 the
// cycles from barrier to barrier (row [WARPS]); egnn_loop_bwd_phases
// copies them out and clears them. Phases: 0 row set-up, 1 S0 build, 2 S1,
// 3 S2 (B), 4 S3, 5 P, 6 row end. Without the flag phase_sync(k) is a
// barrier.
#ifdef PMHC_LOOP_PHASES
constexpr int NPHASE = 7;
__device__ unsigned long long g_phase_cycles[WARPS + 1][NPHASE];
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
#define phase_sync(k)                                                                   \
  do {                                                                                  \
    const long long t_arrive = clock_now();                                             \
    if (lane == 0) atomicAdd(&g_phase_cycles[warp][k], (unsigned long long)(t_arrive - t_phase)); \
    asm volatile("bar.sync 0;" ::: "memory");                                           \
    const long long t_now = clock_now();                                                \
    if (tid == 0) atomicAdd(&g_phase_cycles[WARPS][k], (unsigned long long)(t_now - t_phase)); \
    t_phase = t_now;                                                                    \
  } while (0)
#else
#define phase_sync(k) __syncthreads()
#endif

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    egnn_loop_bwd_kernel(const Inputs in, const BwdIO io) {
  using S = BSmem<MODE>;
  constexpr bool BF16 = MODE == MODE_BF16;
  constexpr bool MMA = MODE != MODE_FP32;  // bf16 and high: the tasks on the tensor cores
  extern __shared__ __align__(16) float smem[];
  float* sm = smem;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int NP = in.NP;
  const int rows = in.B * in.N;
  const int per_block = (rows + gridDim.x - 1) / gridDim.x;
  const int row_lo = min(rows, (int)blockIdx.x * per_block);
  const int row_hi = min(rows, row_lo + per_block);

  // -- the block's weights, once ------------------------------------------
  // (the weight pointers are rebuilt from in.w where they are used: kept
  // live across the rows, they would cost 20 registers)
  if constexpr (BF16) {
    const LoopW lw = loop_w(in.w);
    uint2* whf = reinterpret_cast<uint2*>(sm + S::WHM);  // B[k = column][n = unit] = whm[unit][column]
    for (int e = tid; e < 4 * 8 * 4 * 32; e += THREADS) {
      const int l = e & 31, ks = (e >> 5) & 3, nt = e >> 7;
      const float* wr = lw.whm + (nt * 8 + (l >> 2)) * T + 16 * ks + 2 * (l & 3);
      whf[e] = make_uint2(pack_bf16x2(wr[0], wr[1]), pack_bf16x2(wr[8], wr[9]));
    }
    uint2* wht = reinterpret_cast<uint2*>(sm + S::WHT);  // B[k = unit][n = column] = whm[unit][column]
    for (int e = tid; e < 8 * 16 * 32; e += THREADS) {
      const int l = e & 31, ks = (e >> 5) & 15, nt = e >> 9;
      const float* wc = lw.whm + (16 * ks + 2 * (l & 3)) * T + 8 * nt + (l >> 2);
      wht[e] = make_uint2(pack_bf16x2(wc[0], wc[T]), pack_bf16x2(wc[8 * T], wc[9 * T]));
    }
    uint2* w2f = reinterpret_cast<uint2*>(sm + S::W2F);  // B[k = unit][n = lin2 row], rows padded to 8
    for (int e = tid; e < 4 * 4 * 32; e += THREADS) {
      const int l = e & 31, t = (e >> 5) & 3, hd = e >> 7, n = l >> 2;
      const float* wr = lw.w2 + (row0_of(hd) + n) * T + 16 * t + 2 * (l & 3);
      w2f[e] = n < rows_of(hd) ? make_uint2(pack_bf16x2(wr[0], wr[1]), pack_bf16x2(wr[8], wr[9]))
                               : make_uint2(0u, 0u);
    }
    uint32_t* w2t = reinterpret_cast<uint32_t*>(sm + S::W2T);  // B[k = lin2 row][n = unit], k >= 8 zero
    for (int e = tid; e < 4 * 8 * 32; e += THREADS) {
      const int l = e & 31, nt = (e >> 5) & 7, hd = e >> 8;
      const int o = 2 * (l & 3), uu = 8 * nt + (l >> 2), R = rows_of(hd), R0 = row0_of(hd);
      w2t[e] = pack_bf16x2(o < R ? lw.w2[(R0 + o) * T + uu] : 0.f, o + 1 < R ? lw.w2[(R0 + o + 1) * T + uu] : 0.f);
    }
  } else {
    const LoopW lw = loop_w(in.w);
    // whm rows: 16-byte copies where the buffer is aligned, else 4-byte
    const bool al = (reinterpret_cast<uintptr_t>(lw.whm) & 15) == 0;
    for (int e = tid; e < HEADS * T / 4; e += THREADS) {
      const int u = e / (T / 4), k4 = e % (T / 4);
      float* dst = sm + S::WHM + u * HF_LD + 4 * k4;
      const float* src = lw.whm + u * T + 4 * k4;
      if (al) {
        cp_async16(dst, src);
      } else {
        for (int c = 0; c < 4; ++c) cp_async4(dst + c, src + c);
      }
    }
    cp_async_commit();
    for (int e = tid; e < NOUT * T; e += THREADS) sm[S::W2S + e] = lw.w2[e];
  }
  for (int e = tid; e < HEADS * T / 4; e += THREADS)
    reinterpret_cast<float4*>(sm + S::DW)[e] = float4{0.f, 0.f, 0.f, 0.f};
  for (int e = tid; e < 3 * NOUT * T; e += THREADS) sm[S::DW2 + e] = 0.f;
  for (int e = tid; e < BT * 8; e += THREADS) sm[S::RQL + e] = 0.f;  // re-zeroed as each row reads it
  for (int e = tid; e < S::DAI_SLOTS * T; e += THREADS) sm[S::DAI + e] = 0.f;  // the same
  cp_async_wait_all();
  __syncthreads();
#ifdef PMHC_LOOP_PHASES
  long long t_phase = clock_now();
#endif

  // the S1 / S3 task of this warp: 16-neighbour block jb x head hd (the heads
  // rotate over the SM's four sub-partitions, warp % 4)
  const int jb = 16 * (warp >> 2), hd = (warp + (warp >> 2)) & 3;
  // warps 0-7, thread = head unit tid: its sums over the block's rows
  float accb = 0.f;                      // its bias
  float accx[4] = {0.f, 0.f, 0.f, 0.f};  // att: wad, waq; rot: wrq[4]
  float db2 = 0.f;                       // lin2 bias row tid (tid < NOUT)
  const bool aligned = ((reinterpret_cast<uintptr_t>(in.aj) | reinterpret_cast<uintptr_t>(in.edge)) &
                        (BF16 ? 7 : 15)) == 0;
  int cur_b = -1;

  for (int row = row_lo; row < row_hi; ++row) {
    const int b = row / in.N;
    const int i = row - b * in.N;
    if (tid < T) {
      sm[S::AI + tid] = in.ai[(size_t)row * T + tid];
      sm[S::GH + tid] = io.gHID[(size_t)row * T + tid];
      sm[S::TN + tid] = in.tor[(size_t)row * T + tid] + __ldg(loop_w(in.w).bt1 + tid);
    } else if (tid < T + 4) {
      sm[S::NODE + tid - T] = in.qi[(size_t)row * 4 + tid - T];
    } else if (tid < T + 7) {
      sm[S::NODE + tid - T] = in.ti[(size_t)row * 3 + tid - T - 4];
    } else if (tid == 96) {
      sm[S::CT + CT_M] = io.m[row];
    } else if (tid == 97) {
      sm[S::CT + CT_D] = io.gD[row];
    } else if (tid >= 98 && tid < 102) {
      sm[S::CT + CT_GD + tid - 98] = io.gGD[(size_t)row * 4 + tid - 98];
    } else if (tid >= 102 && tid < 102 + NTOR) {
      sm[S::CT + CT_TA + tid - 102] = io.gTA[(size_t)row * NTOR + tid - 102];
    } else if (tid >= 109 && tid < 112) {
      sm[S::CT + CT_TR + tid - 109] = io.gTR[(size_t)row * 3 + tid - 109];
    }
    if (b != cur_b) {  // a new batch element: its neighbours' q_j, q_j^-1, t_j
      for (int j = tid; j < NP; j += THREADS) {
        float* f = sm + S::FRM + j * FR_LD;
        float q_j[4];
        for (int c = 0; c < 4; ++c) q_j[c] = in.qj[((size_t)b * NP + j) * 4 + c];
        // zero-quat guard: padded frames may carry all-zero quats
        const float n2 = fmaxf(q_j[0] * q_j[0] + q_j[1] * q_j[1] + q_j[2] * q_j[2] + q_j[3] * q_j[3],
                               1e-30f);
        for (int c = 0; c < 4; ++c) {
          f[F_QJ + c] = q_j[c];
          f[F_INV + c] = (c == 0 ? q_j[c] : -q_j[c]) / n2;
        }
        for (int c = 0; c < 3; ++c) f[F_TJ + c] = in.tj[((size_t)b * NP + j) * 3 + c];
      }
      cur_b = b;
    }
    float rowb = 0.f;                       // warps 0-7: d(pre_heads)[tid] summed over the row
    phase_sync(0);

    for (int j0 = 0; j0 < NP; j0 += BT) {
      const int nj = min(BT, NP - j0);
      // -- S0: the hid tile (rows past nj zero), the geometry records --------
      if constexpr (BF16) {
        uint32_t* ha = reinterpret_cast<uint32_t*>(sm + S::HID);
        uint32_t* ht = reinterpret_cast<uint32_t*>(sm + S::HIDT);
        for (int e = tid; e < (BT / 2) * (T / 2); e += THREADS) {
          const int p = e / (T / 2), q = e % (T / 2);  // neighbours 2p, 2p + 1; columns 2q, 2q + 1
          float v[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 2 * p + r;
            v[r][0] = v[r][1] = 0.f;
            if (j < nj) {
              const float* x = in.aj + ((size_t)b * NP + j0 + j) * T + 2 * q;
              const float* y = in.edge + ((size_t)i * NP + j0 + j) * T + 2 * q;
              float2 xv, yv;
              if (aligned) {
                xv = *reinterpret_cast<const float2*>(x);
                yv = *reinterpret_cast<const float2*>(y);
              } else {
                xv = float2{x[0], x[1]};
                yv = float2{y[0], y[1]};
              }
              v[r][0] = fmaxf(sm[S::AI + 2 * q] + xv.x + yv.x, 0.f);
              v[r][1] = fmaxf(sm[S::AI + 2 * q + 1] + xv.y + yv.y, 0.f);
            }
          }
          ha[(2 * p) * HA_LD + q] = pack_bf16x2(v[0][0], v[0][1]);
          ha[(2 * p + 1) * HA_LD + q] = pack_bf16x2(v[1][0], v[1][1]);
          ht[(2 * q) * HT_LD + p] = pack_bf16x2(v[0][0], v[1][0]);
          ht[(2 * q + 1) * HT_LD + p] = pack_bf16x2(v[0][1], v[1][1]);
        }
      } else {
        for (int e = tid; e < BT * T / 4; e += THREADS) {
          const int j = e / (T / 4), k4 = e % (T / 4);
          float4 h = float4{0.f, 0.f, 0.f, 0.f};
          if (j < nj) {
            const float* x = in.aj + ((size_t)b * NP + j0 + j) * T + 4 * k4;
            const float* y = in.edge + ((size_t)i * NP + j0 + j) * T + 4 * k4;
            const float4 xv = aligned ? ld4(x) : float4{x[0], x[1], x[2], x[3]};
            const float4 yv = aligned ? ld4(y) : float4{y[0], y[1], y[2], y[3]};
            const float4 av = ld4(sm + S::AI + 4 * k4);
            h = float4{fmaxf(av.x + xv.x + yv.x, 0.f), fmaxf(av.y + xv.y + yv.y, 0.f),
                       fmaxf(av.z + xv.z + yv.z, 0.f), fmaxf(av.w + xv.w + yv.w, 0.f)};
          }
          *reinterpret_cast<float4*>(sm + S::HID + j * HF_LD + 4 * k4) = h;
        }
      }
      if (tid >= 320 && tid < 320 + BT) {
        const int jj = tid - 320;
        float* g = sm + S::GEOS + jj * GEO_LD;
        if (jj < nj) {
          const float* f = sm + S::FRM + (j0 + jj) * FR_LD;
          const float* q_i = sm + S::NODE;
          float dx[3], tmp[4], lq[4];
          for (int c = 0; c < 3; ++c) dx[c] = sm[S::NODE + 4 + c] - f[F_TJ + c];
          const float d2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
          const float qdot = q_i[0] * f[F_QJ] + q_i[1] * f[F_QJ + 1] + q_i[2] * f[F_QJ + 2] +
                             q_i[3] * f[F_QJ + 3];
          qmul(q_i, f + F_QJ, tmp);
          qmul(f + F_INV, tmp, lq);
          g[G_ND2] = -d2;
          g[G_QD2] = qdot * qdot;
          for (int c = 0; c < 4; ++c) {
            g[G_LQ + c] = rnd<BF16>(lq[c]);  // bf16: the products' operand, rounded once
            g[G_INV + c] = f[F_INV + c];
            g[G_QJ + c] = f[F_QJ + c];
          }
          for (int c = 0; c < 3; ++c) g[G_DX + c] = dx[c];
          g[G_MASK] = in.mask[(size_t)row * NP + j0 + jj];
        } else {
          for (int c = 0; c < GEO; ++c) g[c] = 0.f;
        }
      }
      phase_sync(1);

      const LoopW lw = loop_w(in.w);
      float* dw2 = sm + S::DW2 + (jb / 16) * NOUT * T;  // this task's dW2 sums over the block's rows
      // -- S1: act into DP and the lin2 rows ------------------------------------
      if constexpr (BF16) {
        if (hd == 0) s1_bf16<0>(sm, lw, jb, lane);
        else if (hd == 1) s1_bf16<1>(sm, lw, jb, lane);
        else if (hd == 2) s1_bf16<2>(sm, lw, jb, lane);
        else s1_bf16<3>(sm, lw, jb, lane);
      } else if constexpr (MMA) {
        if (hd == 0) s1_high<0>(sm, lw, jb, lane);
        else if (hd == 1) s1_high<1>(sm, lw, jb, lane);
        else if (hd == 2) s1_high<2>(sm, lw, jb, lane);
        else s1_high<3>(sm, lw, jb, lane);
      } else {
        if (hd == 0) s1_fp32<0>(sm, lw, jb, lane);
        else if (hd == 1) s1_fp32<1>(sm, lw, jb, lane);
        else if (hd == 2) s1_fp32<2>(sm, lw, jb, lane);
        else s1_fp32<3>(sm, lw, jb, lane);
      }
      phase_sync(2);

      // -- S2 = B: value-path adjoints (warps 8-9, lane = neighbour) ----------
      // The lane's lin2 output row then holds its d(q_j)[4], d(q_j^-1)[4],
      // d(t_j)[3] for phase F; d(t_i) goes to its RQL slot.
      const int jl = 32 * (warp - 8) + lane;
      const bool nbr = (warp == 8 || warp == 9) && jl < nj;
      if (nbr) {
        const float* ct = sm + S::CT;
        const float* g = sm + S::GEOS + jl * GEO_LD;
        float* ov = sm + S::OUTS + jl * DV_LD;
        float* rq = sm + S::RQL + jl * 8;
        const float* inv = g + G_INV;
        const float* q_j = g + G_QJ;
        const float* dx = g + G_DX;
        const float logit = ov[0] - (1.f - g[G_MASK]) * 1e9f;
        const float e = expf(logit - ct[CT_M]);
        float ld[4], u[4], gdl[4], c1[4], c2[4], nb[11];
        for (int c = 0; c < 4; ++c) ld[c] = 1.f / (1.f + expf(-ov[1 + c]));
        qmul(ld, inv, u);
        qmul(q_j, u, gdl);
        const float mtr = ov[12];
        float ge = ct[CT_D];
        for (int c = 0; c < 4; ++c) ge += ct[CT_GD + c] * gdl[c];
        for (int k = 0; k < NTOR; ++k) ge += ct[CT_TA + k] * ov[5 + k];
        for (int c = 0; c < 3; ++c) ge += ct[CT_TR + c] * mtr * dx[c];
        float* dv = sm + S::DOUT + jl * DV_LD;
        dv[0] = e * ge;
        float dgd[4], dmtr = 0.f;
        for (int c = 0; c < 4; ++c) dgd[c] = e * ct[CT_GD + c];
        for (int k = 0; k < NTOR; ++k) dv[5 + k] = e * ct[CT_TA + k];
        for (int c = 0; c < 3; ++c) {
          const float dmr = e * ct[CT_TR + c];
          dmtr += dmr * dx[c];
          rq[4 + c] += dmr * mtr;
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
        for (int c = 0; c < 11; ++c) ov[c] = nb[c];
      }
      phase_sync(3);

      // -- S3: lin2 backward -> d(pre_heads), dW2, phase E ----------------------
      if constexpr (BF16) {
        if (hd == 0) s3_bf16<0>(sm, lw, jb, nj, lane, dw2);
        else if (hd == 1) s3_bf16<1>(sm, lw, jb, nj, lane, dw2);
        else if (hd == 2) s3_bf16<2>(sm, lw, jb, nj, lane, dw2);
        else s3_bf16<3>(sm, lw, jb, nj, lane, dw2);
      } else if constexpr (MMA) {
        if (hd == 0) s3_high<0>(sm, lw, jb, nj, lane, dw2);
        else if (hd == 1) s3_high<1>(sm, lw, jb, nj, lane, dw2);
        else if (hd == 2) s3_high<2>(sm, lw, jb, nj, lane, dw2);
        else s3_high<3>(sm, lw, jb, nj, lane, dw2);
      } else {
        if (hd == 0) s3_fp32<0>(sm, lw, jb, nj, lane, dw2);
        else if (hd == 1) s3_fp32<1>(sm, lw, jb, nj, lane, dw2);
        else if (hd == 2) s3_fp32<2>(sm, lw, jb, nj, lane, dw2);
        else s3_fp32<3>(sm, lw, jb, nj, lane, dw2);
      }
      phase_sync(4);

      float dai[4] = {0.f, 0.f, 0.f, 0.f};  // d(a_i) of the lane's d(hid) columns, this tile
      // -- P: warps 0-7 dwhm, (fp32) d(hid) of neighbours 32-47, the units'
      // -- sums; warps 8-9 phase F; warps 8-11 d(hid) of neighbours 0-31
      // -- (fp32) or 0-47 (bf16) ------------------------------------------------
      {
        const size_t aj0 = ((size_t)b * NP + j0) * T, ed0 = ((size_t)i * NP + j0) * T;
        if (warp < 8) {
          if constexpr (BF16) {
            p3_bf16(sm, warp, lane);
          } else if constexpr (MMA) {
            p3_high(sm, warp, lane);
          } else {
            p3_fp32(sm, warp, lane);
            p2b_fp32(sm, io, aj0, ed0, nj, warp, lane, dai);
          }
          // thread = head unit tid: its sums over the tile's neighbours (rows
          // past nj carry zeros)
          const int head = tid / T;  // warp-uniform
#pragma unroll 8
          for (int jj = 0; jj < BT; ++jj) {
            const float d = sm[S::DP + jj * DP_LD + tid];
            const float* g = sm + S::GEOS + jj * GEO_LD;
            rowb += d;
            if (head == 0) {
              accx[0] = fmaf(d, g[G_ND2], accx[0]);
              accx[1] = fmaf(d, g[G_QD2], accx[1]);
            } else if (head == 1) {  // the record's local quat is rounded in bf16 mode
              const float dr = rnd<BF16>(d);
#pragma unroll
              for (int c = 0; c < 4; ++c) accx[c] = fmaf(dr, g[G_LQ + c], accx[c]);
            }
          }
          if (tid < NOUT) {
            for (int jj = 0; jj < nj; ++jj) db2 += sm[S::DOUT + jj * DV_LD + tid];
          }
        } else {
          // F: quaternion and distance adjoints (warps 8-9, lane = neighbour)
          if (nbr) {
            const int j = j0 + jl;
            const float* g = sm + S::GEOS + jl * GEO_LD;
            const float* q_i = sm + S::NODE;
            const float* q_j = g + G_QJ;
            const float* inv = g + G_INV;
            const float* dx = g + G_DX;
            const float* dl = sm + S::REDS + jl * RED_LD;
            const float* nb = sm + S::OUTS + jl * DV_LD;
            float* rq = sm + S::RQL + jl * 8;
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
            for (int c = 0; c < 4; ++c) rq[c] += t4[c];
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
              rq[4 + c] += 2.f * dd2 * dx[c];
              dtj[c] -= 2.f * dd2 * dx[c];
            }
            for (int c = 0; c < 4; ++c) {
              rq[c] += dqdot * q_j[c];
              dqj[c] += dqdot * q_i[c];
            }
            for (int c = 0; c < 4; ++c) atomicAdd(io.dqj + ((size_t)b * NP + j) * 4 + c, dqj[c]);
            for (int c = 0; c < 3; ++c) atomicAdd(io.dtj + ((size_t)b * NP + j) * 3 + c, dtj[c]);
          }
          if constexpr (BF16) {
            p2_bf16<3, 2>(sm, io, aj0, ed0, nj, 0, 2 * (warp - 8), lane, dai);
          } else if constexpr (MMA) {
            p2_high<3, 2>(sm, io, aj0, ed0, nj, 0, 2 * (warp - 8), lane, dai);
          } else {
            p2a_fp32(sm, io, aj0, ed0, nj, warp, lane, dai);
          }
        }
      }
      // d(a_i): the lanes' sums over this tile's neighbours, reduced over the
      // lanes that share columns, added to slots of disjoint columns
      if constexpr (MMA) {
        if (warp >= 8) {  // over the 8 g lanes; lanes 0-3: columns 16 (w - 8) + 8nn + 2c + r
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 4);
            dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 8);
            dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 16);
          }
          if (lane < 4) {
#pragma unroll
            for (int k = 0; k < 4; ++k) sm[S::DAI + 16 * (warp - 8) + 8 * (k >> 1) + 2 * lane + (k & 1)] += dai[k];
          }
        }
      } else if (warp >= 8) {  // over the 2 nq lanes; slot w - 8, columns 4cg + k
#pragma unroll
        for (int k = 0; k < 4; ++k) dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 16);
        if (lane < 16) {
#pragma unroll
          for (int k = 0; k < 4; ++k) sm[S::DAI + (warp - 8) * T + 4 * lane + k] += dai[k];
        }
      } else {  // over the 16 neighbour lanes; slot 4, columns 8w + 4h + k
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 2);
          dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 4);
          dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 8);
          dai[k] += __shfl_xor_sync(0xffffffffu, dai[k], 16);
        }
        if (lane < 2) {
#pragma unroll
          for (int k = 0; k < 4; ++k) sm[S::DAI + 4 * T + 8 * warp + 4 * lane + k] += dai[k];
        }
      }
      phase_sync(5);
    }

    // -- row end: d(a_i), d(tor_node), d(q_i), d(t_i) ----------------------------
    if (warp < 8) {
      if (tid / T == 2) io.dtor[(size_t)row * T + tid - 2 * T] = rowb;
      accb += rowb;
    }
    phase_sync(6);
    if (tid < T) {
      float s = 0.f;
      for (int p = 0; p < S::DAI_SLOTS; ++p) {
        s += sm[S::DAI + p * T + tid];
        sm[S::DAI + p * T + tid] = 0.f;
      }
      io.dai[(size_t)row * T + tid] = s;
    } else if (tid < T + 7) {
      float s = 0.f;
      for (int jj = 0; jj < BT; ++jj) {
        s += sm[S::RQL + jj * 8 + tid - T];
        sm[S::RQL + jj * 8 + tid - T] = 0.f;
      }
      if (tid < T + 4) io.dqi[(size_t)row * 4 + tid - T] = s;
      else io.dti[(size_t)row * 3 + tid - T - 4] = s;
    }
  }

  // -- this block's weight-gradient partial sums --------------------------------
  float* part = io.partial + (size_t)blockIdx.x * W_SIZE;
  if (warp < 8) {
    const float4* dw = reinterpret_cast<const float4*>(sm + S::DW) + warp * 16 * 32 + lane;
    for (int s = 0; s < 16; ++s) {
      const float4 v = dw[s * 32];
      if constexpr (MMA) {  // slot mt * 8 + nt: units 32w + 16mt + g (+ 8), columns 8nt + 2c (+ 1)
        const int u = 32 * warp + 16 * (s >> 3) + (lane >> 2), col = 8 * (s & 7) + 2 * (lane & 3);
        part[O_WHM + u * T + col] = v.x;
        part[O_WHM + u * T + col + 1] = v.y;
        part[O_WHM + (u + 8) * T + col] = v.z;
        part[O_WHM + (u + 8) * T + col + 1] = v.w;
      } else {  // slot 2a + h: unit 32w + 4ua + a (a < 4) or 32w + 16 + 4ua + a - 4; columns 4cb (+ 32 h)
        const int a = s >> 1, h = s & 1;
        const int u = 32 * warp + 4 * (lane >> 3) + (a < 4 ? a : 12 + a);
        const int col = 4 * (lane & 7) + 32 * h;
        part[O_WHM + u * T + col] = v.x;
        part[O_WHM + u * T + col + 1] = v.y;
        part[O_WHM + u * T + col + 2] = v.z;
        part[O_WHM + u * T + col + 3] = v.w;
      }
    }
    const int head = tid / T, uu = tid - head * T;
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
    if (tid < NOUT) part[O_B2 + tid] = db2;
  }
  // dW2: the three neighbour blocks' slots summed in order
  for (int e = tid; e < NOUT * T; e += THREADS)
    part[O_W2 + e] = sm[S::DW2 + e] + sm[S::DW2 + NOUT * T + e] + sm[S::DW2 + 2 * NOUT * T + e];
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

template <int MODE>
int launch_fwd(Inputs in, FwdOut out, cudaStream_t stream) {
  static std::atomic<int> sms_of[MAX_DEVICES];
  const int sms = persistent_sms(egnn_loop_fwd_kernel<MODE>, FSmem<MODE>::BYTES, sms_of);
  if (sms < 0) return -sms;
  // one block per SM, each a contiguous run of query rows
  const int rows = in.B * in.N;
  int per_block = (rows + sms - 1) / sms;
  const int grid = (rows + per_block - 1) / per_block;
  void* args[] = {&in, &out, &per_block};
  const cudaError_t err = cudaLaunchKernel(egnn_loop_fwd_kernel<MODE>, dim3(grid), dim3(THREADS), args,
                                           FSmem<MODE>::BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_bwd(Inputs in, BwdIO io, float* dw, int blocks, cudaStream_t stream) {
  if (in.NP > MAXNP) return (int)cudaErrorInvalidValue;
  static std::atomic<int> sms_of[MAX_DEVICES];
  const int sms = persistent_sms(egnn_loop_bwd_kernel<MODE>, BSmem<MODE>::BYTES, sms_of);
  if (sms < 0) return -sms;
  cudaError_t err;
  const size_t nbr = (size_t)in.B * in.NP;
  if ((err = cudaMemsetAsync(io.daj, 0, nbr * T * sizeof(float), stream)) != cudaSuccess ||
      (err = cudaMemsetAsync(io.dqj, 0, nbr * 4 * sizeof(float), stream)) != cudaSuccess ||
      (err = cudaMemsetAsync(io.dtj, 0, nbr * 3 * sizeof(float), stream)) != cudaSuccess ||
      (err = cudaMemsetAsync(io.dedge, 0, (size_t)in.N * in.NP * T * sizeof(float), stream)) !=
          cudaSuccess)
    return (int)err;
  void* args[] = {&in, &io};
  err = cudaLaunchKernel(egnn_loop_bwd_kernel<MODE>, dim3(blocks), dim3(THREADS), args,
                         BSmem<MODE>::BYTES, stream);
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

// Blocks of the backward kernel for ``rows`` query rows: one per SM, each a
// contiguous run of ceil(rows / SMs) rows (the last run may be shorter);
// <= 0 on error.
int egnn_loop_bwd_blocks(int rows) {
  int dev = 0, sms = 0;
  if (rows < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return -1;
  const int per = (rows + sms - 1) / sms;
  return (rows + per - 1) / per;
}

#ifdef PMHC_LOOP_PHASES
// Copies the backward's phase cycle counters ([WARPS + 1][NPHASE]
// unsigned 64-bit) to ``out`` and clears them.
int egnn_loop_bwd_phases(unsigned long long* out) {
  using namespace pmhc;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zero[WARPS + 1][NPHASE];
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

int egnn_loop_fwd_launch(const float* w, const float* ai, const float* tor, const float* qi,
                         const float* ti, const float* aj, const float* qj, const float* tj,
                         const float* edge, const float* mask, float* m, float* D, float* GD,
                         float* TA, float* TR, float* HID, float* CNT, int B, int N, int NP,
                         int mode, void* stream) {
  using namespace pmhc;
  if (B < 1 || N < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  const Inputs in = {w, ai, tor, qi, ti, aj, qj, tj, edge, mask, B, N, NP};
  const FwdOut out = {m, D, GD, TA, TR, HID, CNT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_BF16) return launch_fwd<MODE_BF16>(in, out, s);
  if (mode == MODE_HIGH) return launch_fwd<MODE_HIGH>(in, out, s);
  if (mode != MODE_FP32) return (int)cudaErrorInvalidValue;
  return launch_fwd<MODE_FP32>(in, out, s);
}

int egnn_loop_bwd_launch(const float* w, const float* ai, const float* tor, const float* qi,
                         const float* ti, const float* aj, const float* qj, const float* tj,
                         const float* edge, const float* mask, const float* m, const float* gD,
                         const float* gGD, const float* gTA, const float* gTR, const float* gHID,
                         float* dai, float* dtor, float* dqi, float* dti, float* daj, float* dqj,
                         float* dtj, float* dedge, float* dw, float* partial, int B, int N, int NP,
                         int mode, int blocks, void* stream) {
  using namespace pmhc;
  if (B < 1 || N < 1 || NP < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const Inputs in = {w, ai, tor, qi, ti, aj, qj, tj, edge, mask, B, N, NP};
  const BwdIO io = {m, gD, gGD, gTA, gTR, gHID, dai, dtor, dqi, dti, daj, dqj, dtj, dedge, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_BF16) return launch_bwd<MODE_BF16>(in, io, dw, blocks, s);
  if (mode == MODE_HIGH) return launch_bwd<MODE_HIGH>(in, io, dw, blocks, s);
  if (mode != MODE_FP32) return (int)cudaErrorInvalidValue;
  return launch_bwd<MODE_FP32>(in, io, dw, blocks, s);
}

}  // extern "C"
