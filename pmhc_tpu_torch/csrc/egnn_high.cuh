// The high (--fast-f32) mode's neighbour pipeline on Hopper (sm_90a): the
// tile loop of the fused sampler layer (egnn_fused.cu, TPU kernel #1 with
// mm_maker("high")) and of the training loop's forward (egnn_loop.cu, #4
// "high") on wgmma warpgroups, one template for both. What a kernel adds
// around it: its row groups' node inputs (RG rows at a time: q_i, t_i and
// whatever else its layout's node rows hold; a_i and the torsion node term
// in AI and TN), and its row end (a policy P: P::row_done(fr, ns, row,
// lane) on one warp, after the row's last tile is merged into fr; the
// row's HID sum is in HS when the group is done). The design (warpgroups
// 0-1 consume, 2 produces; named barriers FULL and DONE between them; the
// budget) is described in egnn_fused.cu above egnn_fused_kernel<MODE_HIGH>.
// The loop backward's high kernel (egnn_loop.cu) reuses stage_high,
// issue_head and epilogue_head on layouts of its own.
//   stage_high      whm and the lin2 rows split into bf16 hi / lo sw128
//                   tiles, the extra-term coefficients and b2
//   issue_head      one head's product on a 64-row slab, three passes
//   epilogue_head   + extra term, relu, split; the head's lin2 in flight
//   high_consumer   a consumer warpgroup's items
//   high_producer   the producer warpgroup's: build, prefetch, fold, merge

#pragma once

#include "egnn_tile.cuh"
#include "wgmma.cuh"

#include <stddef.h>
#include <stdint.h>

namespace pmhc {

// Built with -DPMHC_FUSED_PHASES (chip_ab.py --kernel fused --phases) the
// fused layer's high kernel adds up, per warp and phase, the cycles each warp spends in
// each phase of its role (lane 0, clock64); egnn_fused_phases copies them
// out and clears them. Consumers: 0 waiting for FULL, 1 the first two
// head products' issue and the extra terms' operands, 2 waiting for a head
// product, 3 the epilogues with the lin2's (and the next head product's)
// issue, 4 the last wait, the lin2 outputs' store and the arrival at DONE.
// Producer: 5 waiting for the raw inputs (and the last step's fold and
// merge), 6 the build, 7 the prefetch and HID sums, 8 waiting for DONE,
// 9 the fold (warps 9-11), 10 the merge and row outputs (warp 8). All
// warps: 11 the row groups' node terms and feature MLPs and the weight
// staging. Without the flag the marks are empty.
#ifdef PMHC_FUSED_PHASES
constexpr int FUSED_NPHASE = 12;
__device__ unsigned long long g_fused_phases[WARPS][FUSED_NPHASE];
#endif
struct PhaseClock {
#ifdef PMHC_FUSED_PHASES
  long long t;
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    if ((threadIdx.x & 31) == 0) atomicAdd(&g_fused_phases[threadIdx.x >> 5][k], (unsigned long long)(now - t));
    t = now;
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
#endif
};

// Shared memory of the pipeline. The bf16 tiles in the 128B-swizzle
// layout (sw128: 128-byte rows, wgmma's K-major operands), in bytes from a
// base that the kernel aligns to 1024 bytes (the swizzle's atom); then the
// fp32 regions, in floats from the same base; the row group's regions last
// (NODE_W: the floats of a row's node inputs, q_i at N_Q and t_i at N_T
// first). HighSmem::BYTES adds the alignment's 1 KB.
constexpr int N_Q = 0, N_T = 4;
constexpr int RG = 8;  // query rows per row group
template <int NODE_W>
struct HighSmem {
  static constexpr int NODE = NODE_W;
  static constexpr int WHM_H = 0;                      // whm hi [HEADS][T] bf16 (wgmma B, per head 64 rows)
  static constexpr int WHM_L = WHM_H + HEADS * 128;    // whm lo
  static constexpr int W2_H = WHM_L + HEADS * 128;     // lin2 hi [4 heads][16 rows][T] bf16 (wgmma B, n = 16)
  static constexpr int W2_L = W2_H + 4 * 16 * 128;     // lin2 lo
  static constexpr int HIDB = W2_L + 4 * 16 * 128;     // hid tiles [2 buffers][hi, lo][TILE][T] bf16
  static constexpr int HID_HALF = TILE * 128, HID_BUF = 2 * HID_HALF;
  static constexpr int COEF = (HIDB + 2 * HID_BUF) / 4;  // floats from here: [5][HEADS] extra-term c0..c3, cb
  static constexpr int B2 = COEF + 5 * HEADS;            // [16]
  static constexpr int AJ = B2 + 16;                     // the next tile's raw inputs (cp.async): a_j [TILE][T]
  static constexpr int ED = AJ + TILE * T;               // edge [TILE][T]
  static constexpr int QJ = ED + TILE * T;               // q_j [TILE][4]
  static constexpr int TJ = QJ + TILE * 4;               // t_j [TILE * 3]
  static constexpr int MK = TJ + TILE * 3;               // mask [TILE]
  static constexpr int GEOS = MK + TILE;                 // geometry records [2 buffers][TILE][GEO_LD]
  static constexpr int OUTS = GEOS + 2 * TILE * GEO_LD;  // lin2 outputs [2 buffers][TILE][O_LD]
  static constexpr int HSP = OUTS + 2 * TILE * O_LD;     // HID partials [4 producer warps][T]
  static constexpr int FP = HSP + 4 * T;                 // fold partials [2 buffers][3][FOLD]
  static constexpr int FR = FP + 2 * 3 * FOLD;           // the row's running fold
  static constexpr int NS = FR + FOLD;                   // the row group's node inputs [RG][NODE]
  static constexpr int AI = NS + RG * NODE;              // a_i, torsion node terms (+ bt1), HID sums and
  static constexpr int TN = AI + RG * T;                 // feature MLP hiddens [RG][T]
  static constexpr int HS = TN + RG * T;
  static constexpr int FH = HS + RG * T;
  static constexpr int TOTAL = FH + RG * T;
  static constexpr size_t BYTES = TOTAL * sizeof(float) + 1024;
  static_assert(HIDB % 1024 == 0 && W2_H % 1024 == 0, "wgmma operands need 1024-byte aligned tiles");
  static_assert(AJ % 4 == 0 && ED % 4 == 0 && QJ % 4 == 0 && NS % 4 == 0 && AI % 4 == 0, "16-byte regions");
  static_assert(BYTES <= 232448, "high-mode shared memory exceeds the H100's 227 KB");
  static_assert(NODE_W % 4 == 0 && NODE_W >= N_T + 3, "node rows: q_i, t_i, 16-byte multiples");
};

// named barriers (0 is __syncthreads): the producer warpgroup's own; hid
// tile and geometry of buffer k ready (FULL + k: the producer arrives, the
// consumers wait); lin2 outputs of buffer k ready (DONE + k: the consumers
// arrive, the folding warps 9-11 wait)
constexpr int BAR_PROD = 1, BAR_FULL = 2, BAR_DONE = 4;
constexpr int PRODUCER = 256;  // first producer thread (warps 8-11)
constexpr int FULL_COUNT = THREADS, DONE_COUNT = PRODUCER + 96;

// 32-bit word `word` of row `row` of a sw128 tile
__device__ __forceinline__ uint32_t& tile_word(char* tile, int row, int word) {
  return *reinterpret_cast<uint32_t*>(tile + sw128(row, 4 * word));
}

// whm and the lin2 rows split into bf16 hi and lo tiles (sw128), the
// extra-term coefficients of heads 0, 1 and 3 (head 2's come per row from
// the node term) and b2, by all threads, into the regions WHM_H, WHM_L,
// W2_H, W2_L, COEF and B2 of layout S.
template <class S>
__device__ __forceinline__ void stage_high(float* sm, char* tb, const LoopW& w, int tid) {
  for (int e = tid; e < HEADS * T / 2; e += THREADS) {  // whm row u, units 2l, 2l + 1
    const int u = e >> 5, l = e & 31;
    split_bf16x2(__ldg(w.whm + u * T + 2 * l), __ldg(w.whm + u * T + 2 * l + 1), tile_word(tb + S::WHM_H, u, l),
                 tile_word(tb + S::WHM_L, u, l));
  }
  for (int e = tid; e < 4 * 16 * T / 2; e += THREADS) {  // head hd's B rows o < 16: its own lin2 rows, else 0
    const int hd = e >> 9, o = (e >> 5) & 15, l = e & 31;
    uint32_t hi = 0u, lo = 0u;
    if (o >= row0_of(hd) && o < row0_of(hd) + rows_of(hd))
      split_bf16x2(__ldg(w.w2 + o * T + 2 * l), __ldg(w.w2 + o * T + 2 * l + 1), hi, lo);
    tile_word(tb + S::W2_H, 16 * hd + o, l) = hi;
    tile_word(tb + S::W2_L, 16 * hd + o, l) = lo;
  }
  for (int u = tid; u < HEADS; u += THREADS) {
    const int hd = u / T, uu = u - hd * T;
    float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (hd == 0) {
      c[0] = w.wad[uu];
      c[1] = w.waq[uu];
      c[4] = w.ba1[uu];
    } else if (hd == 1) {
      for (int r = 0; r < 4; ++r) c[r] = w.wrq[uu * 4 + r];
      c[4] = w.br1[uu];
    } else if (hd == 3) {
      c[4] = w.bl1[uu];
    }
    for (int r = 0; r < 5; ++r) sm[S::COEF + r * HEADS + u] = c[r];
  }
  if (tid < NOUT) sm[S::B2 + tid] = w.b2[tid];
}

// The head product of one head on a consumer warpgroup's 64-row slab, in
// flight on return: act's pre-activation whm @ hid in three passes (hi*hi +
// hi*lo + lo*hi), twelve m64n64k16 with both operands in shared memory
// (da_h / da_l: the slab's hid hi / lo rows; db_h / db_l: the head's whm
// hi / lo rows), committed as one group.
__device__ __forceinline__ void issue_head(float (&acc)[32], uint64_t da_h, uint64_t da_l, uint64_t db_h,
                                           uint64_t db_l) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_ss<64, 0, 0>(acc, da_h + 2 * ks, db_h + 2 * ks, ks > 0);
    wgmma_ss<64, 0, 0>(acc, da_h + 2 * ks, db_l + 2 * ks, 1);
    wgmma_ss<64, 0, 0>(acc, da_l + 2 * ks, db_h + 2 * ks, 1);
  }
  wgmma_commit();
}

// The epilogue of one head on its finished accumulator, then its lin2 in
// flight: act = relu(acc + extra) split into bf16 hi and lo, in registers
// (the accumulator's two n8 chunks of a k16 step are one A fragment of
// the lin2), and the head's lin2 rows added to lacc (twelve m64n16k16 on
// the head's B rows padded to n = 16: d2h / d2l), committed as one group.
// e_lo / e_hi: the extra term's operands of the thread's rows g and g + 8;
// tn: the row's torsion node terms; a dead thread (rows another warpgroup
// owns) feeds zeros. S::COEF: the coefficients. With GATE (the loop
// backward) also relu's gate, bit k of *gate set where act's element acc[k]
// is positive.
template <class S, int HEAD, bool GATE = false>
__device__ __forceinline__ void epilogue_head(const float* sm, float (&acc)[32], uint64_t d2h, uint64_t d2l,
                                              const float* e_lo, const float* e_hi, const float* tn,
                                              uint32_t (&lh)[4][4], uint32_t (&ll)[4][4], float (&lacc)[8],
                                              bool live, int c, uint32_t* gate = nullptr) {
  constexpr int NC = HEAD == 0 ? 2 : HEAD == 1 ? 4 : 0;  // coefficients c0 .. c(NC - 1) in use
  fence_operand(acc);
  const float* coef = sm + S::COEF + HEAD * T;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      if (!live) {
        lh[t][2 * nn] = lh[t][2 * nn + 1] = ll[t][2 * nn] = ll[t][2 * nn + 1] = 0u;
        continue;
      }
      const int u = 16 * t + 8 * nn + 2 * c;  // the chunk's units u, u + 1 of the head
      float c0[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, c1[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const float2 cv = *reinterpret_cast<const float2*>(coef + r * HEADS + u);
        c0[r] = cv.x;
        c1[r] = cv.y;
      }
      const float2 cb = *reinterpret_cast<const float2*>(HEAD == 2 ? tn + u : coef + 4 * HEADS + u);
      c0[4] = cb.x;
      c1[4] = cb.y;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int i = 4 * (2 * t + nn) + 2 * h8;
        const float* e = h8 ? e_hi : e_lo;
        const float x0 = fmaxf(acc[i] + extra_term<HEAD>(e, c0), 0.f);
        const float x1 = fmaxf(acc[i + 1] + extra_term<HEAD>(e, c1), 0.f);
        split_bf16x2(x0, x1, lh[t][2 * nn + h8], ll[t][2 * nn + h8]);
        if constexpr (GATE) *gate |= (x0 > 0.f ? 1u << i : 0u) | (x1 > 0.f ? 2u << i : 0u);
      }
    }
  }
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    wgmma_rs<16, 0>(lacc, lh[t], d2h + 2 * t, HEAD > 0 || t > 0);
    wgmma_rs<16, 0>(lacc, lh[t], d2l + 2 * t, 1);
    wgmma_rs<16, 0>(lacc, ll[t], d2h + 2 * t, 1);
  }
  wgmma_commit();
}

// A consumer warpgroup (cw = 0: tile rows 0-63; cw = 1: rows 32-95, whose
// warps 4 and 5 hold rows of warpgroup 0 and are dead): items it0 ..
// it0 + n - 1 of the block (row_lo + it / tiles, tile it % tiles; g0 the
// row group's first row), each waiting for its buffer's FULL barrier and
// arriving at DONE when its lin2 outputs are stored. Two accumulators: the
// head product of head h + 1 runs on the tensor cores while the epilogue of
// head h runs on the CUDA cores. The groups retire in issue order: P0 P1
// L0 P2 L1 P3 L2 L3 (P: a head product, L: a lin2), so waiting for all but
// the newest group leaves only P(h + 1) in flight at epilogue h, and L(h - 1)
// has read its A fragments before epilogue h rewrites them (epilogue 3,
// with no P after it, waits for all).
template <class S>
__device__ __forceinline__ void high_consumer(float* sm, uint32_t tb_addr, int it0, int n, int row_lo, int g0,
                                              int tiles, int warp, int lane, PhaseClock& clk) {
  const int cw = warp >> 2, w4 = warp & 3, g = lane >> 2, c = lane & 3;
  const bool live = cw == 0 || w4 >= 2;
  const int r_lo = 32 * cw + 16 * w4 + g, r_hi = r_lo + 8;  // the thread's two tile rows
  const uint64_t dwh = desc_sw128(tb_addr + S::WHM_H), dwl = desc_sw128(tb_addr + S::WHM_L);
  const uint64_t d2h = desc_sw128(tb_addr + S::W2_H), d2l = desc_sw128(tb_addr + S::W2_L);
  constexpr uint64_t HB = 64 * 128 >> 4, H2 = 16 * 128 >> 4;  // a head's B rows, in descriptor units
  for (int k = 0; k < n; ++k) {
    const int it = it0 + k, buf = it & 1;
    const int r = row_lo + it / tiles - g0;  // the row's place in its group
    // the slab's hid rows (hi, lo) of this buffer
    const uint32_t slab = tb_addr + S::HIDB + buf * S::HID_BUF + 32 * cw * 128;
    const uint64_t dah = desc_sw128(slab), dal = desc_sw128(slab + S::HID_HALF);
    bar_sync(BAR_FULL + buf, FULL_COUNT);
    clk.mark(0);
    float acc0[32], acc1[32];
    issue_head(acc0, dah, dal, dwh, dwl);
    issue_head(acc1, dah, dal, dwh + HB, dwl + HB);
    const float* geo = sm + S::GEOS + buf * TILE * GEO_LD;
    float e0[2][2], e1[2][4];  // head 0's -d2, qdot^2 and head 1's local quat, rows g and g + 8
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      pair_operands<0>(geo, h8 ? r_hi : r_lo, e0[h8]);
      pair_operands<1>(geo, h8 ? r_hi : r_lo, e1[h8]);
    }
    const float* tn = sm + S::TN + r * T;  // head 2's extra term, per unit
    float lacc[8];
    uint32_t lh[4][4], ll[4][4];
    clk.mark(1);
    wgmma_wait<1>();
    clk.mark(2);
    epilogue_head<S, 0>(sm, acc0, d2h, d2l, e0[0], e0[1], tn, lh, ll, lacc, live, c);
    issue_head(acc0, dah, dal, dwh + 2 * HB, dwl + 2 * HB);
    clk.mark(3);
    wgmma_wait<1>();
    clk.mark(2);
    epilogue_head<S, 1>(sm, acc1, d2h + H2, d2l + H2, e1[0], e1[1], tn, lh, ll, lacc, live, c);
    issue_head(acc1, dah, dal, dwh + 3 * HB, dwl + 3 * HB);
    clk.mark(3);
    wgmma_wait<1>();
    clk.mark(2);
    epilogue_head<S, 2>(sm, acc0, d2h + 2 * H2, d2l + 2 * H2, e0[0], e0[1], tn, lh, ll, lacc, live, c);
    clk.mark(3);
    wgmma_wait<0>();
    clk.mark(2);
    epilogue_head<S, 3>(sm, acc1, d2h + 3 * H2, d2l + 3 * H2, e0[0], e0[1], tn, lh, ll, lacc, live, c);
    clk.mark(3);
    wgmma_wait<0>();
    fence_operand(lacc);
    if (live) {
      float* out = sm + S::OUTS + buf * TILE * O_LD;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int o = 8 * (e >> 2) + 2 * c + (e & 1);
        if (o < NOUT) out[((e & 2) ? r_hi : r_lo) * O_LD + o] = lacc[e] + sm[S::B2 + o];
      }
    }
    bar_arrive(BAR_DONE + buf, DONE_COUNT);
    clk.mark(4);
  }
}

// The merge of item it (its fold partials fp) into its row's running state
// and, after the row's last tile, the kernel's row end (P::row_done on the
// merged state and the row's node inputs); one warp.
template <class S, class P>
__device__ __forceinline__ void merge_item(float* sm, const float* fp, int it, int row_lo, int g0, int tiles,
                                           int lane, const P& p) {
  const int row = row_lo + it / tiles, tl = it % tiles;
  merge_partials(sm + S::FR, fp, tl == 0, lane);
  if (tl + 1 == tiles) p.row_done(sm + S::FR, sm + S::NS + (row - g0) * S::NODE, row, lane);
}

// The producer warpgroup (warps 8-11, pw = warp - 8, pt = tid - PRODUCER):
// for item it = it0 + k, build its hid tile (split into hi and lo, all four
// warps) and geometry records (warps 8-10) into buffer (it & 1) and arrive
// at FULL; prefetch the next item's raw inputs (cp.async, all four warps)
// and add the HID partials (warps 10-11); warp 8 merges item it - 2 (and
// writes its row's outputs) while warps 9-11 wait for item it - 1's DONE
// and fold it into the fold partials of buffer ((it - 1) & 1). The last
// step folds the group's last item; its merge follows.
template <class S, class P>
__device__ __forceinline__ void high_producer(float* sm, char* tb, const TileSrc& src, int it0, int n, int items,
                                              int row_lo, int g0, int N, int NP, int tiles, int warp, int lane,
                                              const P& p, PhaseClock& clk) {
  const int pw = warp - 8, pt = threadIdx.x - PRODUCER;
  for (int k = 0; k <= n; ++k) {
    if (k < n) cp_async_wait_all();
    bar_sync(BAR_PROD, 128);  // the item's raw inputs have landed; the last fold and merge are done
    clk.mark(5);
    if (k < n) {
      const int it = it0 + k, buf = it & 1;
      const int row = row_lo + it / tiles, tl = it % tiles, r = row - g0, b = row / N;
      const int nj = min(TILE, NP - tl * TILE);
      const float* ns = sm + S::NS + r * S::NODE;
      const float2 ai2 = *reinterpret_cast<const float2*>(sm + S::AI + r * T + 2 * lane);
      char* hh = tb + S::HIDB + buf * S::HID_BUF;
      float hs0 = 0.f, hs1 = 0.f;
#pragma unroll 4
      for (int j = pw; j < TILE; j += 4) {
        float v0 = 0.f, v1 = 0.f;
        if (j < nj) {
          const float2 x = *reinterpret_cast<const float2*>(sm + S::AJ + j * T + 2 * lane);
          const float2 y = *reinterpret_cast<const float2*>(sm + S::ED + j * T + 2 * lane);
          v0 = fmaxf(ai2.x + x.x + y.x, 0.f);
          v1 = fmaxf(ai2.y + x.y + y.y, 0.f);
          hs0 += v0;
          hs1 += v1;
        }
        split_bf16x2(v0, v1, tile_word(hh, j, lane), tile_word(hh + S::HID_HALF, j, lane));
      }
      sm[S::HSP + pw * T + 2 * lane] = hs0;
      sm[S::HSP + pw * T + 2 * lane + 1] = hs1;
      if (pt < TILE) {
        float* gr = sm + S::GEOS + (buf * TILE + pt) * GEO_LD;
        if (pt < nj) {
          geo_record<MODE_HIGH>(gr, sm + S::QJ + pt * 4, sm + S::TJ + pt * 3, sm[S::MK + pt], ns + N_Q, ns + N_T);
        } else {
          for (int cc = 0; cc < GEO; ++cc) gr[cc] = 0.f;
        }
      }
      fence_proxy_async();  // the hid tile, for the consumers' wgmma reads
      bar_arrive(BAR_FULL + buf, FULL_COUNT);
      clk.mark(6);
      bar_sync(BAR_PROD, 128);  // the raw buffers are free; the HID partials are in
      if (it + 1 < items) {
        const int nrow = row_lo + (it + 1) / tiles, ntl = (it + 1) % tiles, nb = nrow / N;
        prefetch_raw<128>(RawTile{sm + S::AJ, sm + S::ED, sm + S::QJ, sm + S::TJ, sm + S::MK}, src, nb,
                          nrow - nb * N, nrow, ntl, nb != b || ntl != tl, pt);
      }
      cp_async_commit();
      if (pt >= 2 * 32) {
        const int u = pt - 2 * 32;
        float hsum = sm[S::HS + r * T + u];
        for (int w4 = 0; w4 < 4; ++w4) hsum += sm[S::HSP + w4 * T + u];
        sm[S::HS + r * T + u] = hsum;
      }
      clk.mark(7);
    }
    if (pw == 0) {
      if (k >= 2) merge_item<S>(sm, sm + S::FP + (k & 1) * 3 * FOLD, it0 + k - 2, row_lo, g0, tiles, lane, p);
      clk.mark(10);
    } else if (k > 0) {
      const int it = it0 + k - 1, buf = it & 1;
      const int nj = min(TILE, NP - (it % tiles) * TILE);
      bar_sync(BAR_DONE + buf, DONE_COUNT);
      clk.mark(8);
      fold_rows(sm + S::GEOS + buf * TILE * GEO_LD, sm + S::OUTS + buf * TILE * O_LD,
                sm + S::FP + buf * 3 * FOLD, nj, pw - 1, lane);
      clk.mark(9);
    }
  }
  bar_sync(BAR_PROD, 128);  // the last fold is in
  const int last = it0 + n - 1;
  if (pw == 0) merge_item<S>(sm, sm + S::FP + (last & 1) * 3 * FOLD, last, row_lo, g0, tiles, lane, p);
  clk.mark(10);
}

}  // namespace pmhc
