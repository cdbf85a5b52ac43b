// Warpgroup-level PTX primitives of the high (--fast-f32) mode on Hopper
// (sm_90a; wgmma exists only for the "a" target), one device function
// each: the fused layer's pipeline and the loop backward. Under the CPU
// emulation of csrc/emu/ (PMHC_CUDA_EMU) each body follows the PTX ISA: a
// wgmma is queued at issue and runs at the wait_group that retires its
// group (so a read of the accumulator before the wait sees the old values,
// as on the card); A fragments travel between the lanes of a warp through
// EmuBlock::frag; shared-memory operands are read through their
// descriptors, with the 128-byte swizzle applied to the address as the
// card applies it.
//   smem_addr            a shared-memory pointer's address in the shared
//                        window (cvta.to.shared)
//   sw128                byte offset of (row, byte) in a tile of 128-byte
//                        rows in the 128B-swizzle layout: the 16-byte chunk
//                        index XOR the row's index mod 8
//   desc_sw128           wgmma matrix descriptor of a K-major such tile
//                        (row = M or N index, 64 k a row): start address
//                        >> 4 (bits 0-13), leading byte offset 1 (unused by
//                        a swizzled K-major operand; bits 16-29), stride
//                        byte offset 1024 >> 4 between 8-row groups (bits
//                        32-45), base offset 0, layout 1 = 128B swizzle
//                        (bits 62-63). The tile must start 1024-byte
//                        aligned; a k-step of 16 bf16 (32 bytes) adds 2.
//   desc_sw128_mn        the same for an MN-major (transposed) tile: row =
//                        k, 64 M or N elements a row; 8-k groups 1024 bytes
//                        apart (stride and leading byte offsets both 1024,
//                        so the operand reads the same whichever of the
//                        two the card takes for the K direction: no operand
//                        here is wider than 64 along M or N). A k-step of
//                        16 rows adds 128; 16 elements along M or N (32
//                        bytes) add 2, as a K-major k-step does.
//   wgmma_ss<N, TA, TB>  D[64 x N] (+)= A[64 x 16] * B[N x 16]^T, both from
//                        shared memory through descriptors, TA / TB = 1:
//                        the operand MN-major (wgmma's transpose bits); N
//                        = 48 or 64. D fp32 in registers: per warp the
//                        m16n8 C fragment of its 16 rows, n8 chunk i in
//                        d[4i .. 4i + 3]; scale_d = 0: D = A * B
//   wgmma_rs<N, TB>      the same with A from registers (per warp the
//                        mma.m16n8k16 A fragment of its 16 rows); N = 16
//                        or 64
//   wgmma_fence / wgmma_commit / wgmma_wait<N>
//                        wgmma.fence (registers written before it are
//                        seen by the wgmmas after it), commit_group,
//                        wait_group N (all but the newest N groups done)
//   fence_operand        keeps the compiler from moving accesses of a
//                        register across the surrounding wgmma primitives
//                        (an accumulator; an A fragment, whose registers
//                        must hold until the wait that retires its wgmma)
//   fence_proxy_async    shared-memory writes before it are seen by the
//                        async proxy (wgmma's operand reads)
//   bar_sync / bar_arrive
//                        named barrier ID of N threads (a multiple of
//                        32): wait for all N, or arrive without waiting;
//                        writes before the arrival are seen after the wait

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pmhc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#if defined(__CUDA_ARCH__)
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#elif defined(PMHC_CUDA_EMU)
  return emu_smem_addr(p);
#else
  return 0u;
#endif
}

__host__ __device__ constexpr uint32_t sw128(int row, int byte) {
  return (uint32_t)(row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15));
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#if defined(PMHC_CUDA_EMU) && !defined(__CUDA_ARCH__)
// element (mn, k) of a bf16 operand (mn: its M or N index), decoded from
// its descriptor as the card reads it: K-major (row mn, k along it) or,
// with tnsp, MN-major (row k, mn along it; 64-element blocks of mn at the
// leading byte offset)
inline float emu_desc_elem(uint64_t desc, int mn, int k, int tnsp) {
  const uint32_t start = (uint32_t)(desc & 0x3fffu) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fffu) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fffu) << 4;
  if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0) std::abort();  // only the 128B swizzle, base offset 0
  const int row = tnsp ? k : mn, col = tnsp ? mn % 64 : k;
  uint32_t addr = start + (uint32_t)(row / 8) * sbo + (uint32_t)(row % 8) * 128 + (uint32_t)col * 2 +
                  (tnsp ? (uint32_t)(mn / 64) * lbo : 0u);
  addr ^= ((addr >> 7) & 7) << 4;
  uint16_t v;
  std::memcpy(&v, emu_smem_at(addr), 2);
  return __bfloat162float(__nv_bfloat16{v});
}

// one queued wgmma, run by every thread of the warpgroup for its own D
// elements (the lanes of a warp swap A fragments first)
inline void emu_wgmma_run(const EmuWgmma& op) {
  const int wl = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t(*f)[6] = emu_blk->frag[wl];
  if (op.a)
    for (int r = 0; r < 4; ++r) f[l][r] = op.a[r];
  __syncwarp();
  const int w4 = wl % 4;  // the warp's 16 rows of the 64
  auto elem = [](uint32_t reg, int k) {
    return __bfloat162float(__nv_bfloat16{uint16_t(k % 2 ? reg >> 16 : reg & 0xffffu)});
  };
  float out[32];
  for (int i = 0; i < op.n / 8; ++i) {
    for (int e = 0; e < 4; ++e) {
      const int row = l / 4 + 8 * (e / 2), col = 8 * i + 2 * (l % 4) + e % 2;
      float acc = op.scale_d ? op.d[4 * i + e] : 0.f;
      for (int k = 0; k < 16; ++k) {
        const float x = op.a ? elem(f[(row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k)
                             : emu_desc_elem(op.desc_a, 16 * w4 + row, k, op.ta);
        acc = fmaf(x, emu_desc_elem(op.desc_b, col, k, op.tb), acc);  // bf16 x bf16 is exact in fp32
      }
      out[4 * i + e] = acc;
    }
  }
  __syncwarp();
  for (int e = 0; e < op.n / 2; ++e) op.d[e] = out[e];
}
#endif

#define PMHC_D8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
    "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 48 || N == 64, "wgmma_ss: N = 48 or 64");
#if defined(__CUDA_ARCH__)
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : PMHC_D8(0), PMHC_D8(8), PMHC_D8(16), PMHC_D8(24)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, %27, %28;\n"
        "}\n"
        : PMHC_D8(0), PMHC_D8(8), PMHC_D8(16)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
#elif defined(PMHC_CUDA_EMU)
  emu_wgmma_q.open.push_back(EmuWgmma{d, N, nullptr, da, db, scale_d, TA, TB});
#endif
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 64, "wgmma_rs: N = 16 or 64");
#if defined(__CUDA_ARCH__)
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : PMHC_D8(0), PMHC_D8(8), PMHC_D8(16), PMHC_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
        "}\n"
        : PMHC_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
#elif defined(PMHC_CUDA_EMU)
  emu_wgmma_q.open.push_back(EmuWgmma{d, N, a, 0, db, scale_d, 0, TB});
#endif
}
#undef PMHC_D8

__device__ __forceinline__ void wgmma_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#elif defined(PMHC_CUDA_EMU)
  emu_wgmma_q.groups.push_back(std::move(emu_wgmma_q.open));
  emu_wgmma_q.open.clear();
#endif
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#elif defined(PMHC_CUDA_EMU)
  while (emu_wgmma_q.groups.size() > (size_t)N) {
    for (const EmuWgmma& op : emu_wgmma_q.groups.front()) emu_wgmma_run(op);
    emu_wgmma_q.groups.pop_front();
  }
#endif
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&v)[R]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(v[i])::"memory");
#endif
}

template <int R>
__device__ __forceinline__ void fence_operand(uint32_t (&v)[R]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(v[i])::"memory");
#endif
}

template <int R, int C>
__device__ __forceinline__ void fence_operand(uint32_t (&v)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_operand(v[i]);
}

__device__ __forceinline__ void fence_proxy_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void bar_sync(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#elif defined(PMHC_CUDA_EMU)
  emu_named_bar(id, n, true);
#endif
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#elif defined(PMHC_CUDA_EMU)
  emu_named_bar(id, n, false);
#endif
}

}  // namespace pmhc
