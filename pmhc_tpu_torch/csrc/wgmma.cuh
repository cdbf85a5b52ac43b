// Warpgroup-level PTX primitives of the fused layer's high (--fast-f32)
// mode on Hopper (sm_90a; wgmma exists only for the "a" target), one
// device function each. Under the CPU emulation of csrc/emu/
// (PMHC_CUDA_EMU) each body follows the PTX ISA: a wgmma is queued at
// issue and runs at the wait_group that retires its group (so a read of
// the accumulator before the wait sees the old values, as on the card);
// A fragments travel between the lanes of a warp through EmuBlock::frag;
// B is read from the emulated shared memory through its descriptor, with
// the 128-byte swizzle applied to the address as the card applies it.
//   smem_addr            a shared-memory pointer's address in the shared
//                        window (cvta.to.shared)
//   sw128                byte offset of (row, byte) in a K-major tile of
//                        128-byte rows in the 128B-swizzle layout: the
//                        16-byte chunk index XOR the row's index mod 8
//   desc_sw128           wgmma matrix descriptor of such a tile: start
//                        address >> 4 (bits 0-13), leading byte offset 1
//                        (unused by a swizzled K-major operand; bits
//                        16-29), stride byte offset 1024 >> 4 between
//                        8-row groups (bits 32-45), base offset 0, layout
//                        1 = 128B swizzle (bits 62-63). The tile must start
//                        1024-byte aligned; a k-step of 16 bf16 (32 bytes)
//                        adds 2 to the descriptor.
//   wgmma_64x64_ss       D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T: A and
//                        B bf16 K-major from shared memory (descriptors),
//                        D fp32 in registers (per warp the m16n8 C
//                        fragment of its 16 rows, n8 chunk i in
//                        d[4i .. 4i + 3]); scale_d = 0: D = A * B
//   wgmma_64x16_rs       D[64 x 16] (+)= A[64 x 16] * B[16 x 16]^T: A from
//                        registers (per warp the mma.m16n8k16 A fragment
//                        of its 16 rows), B through its descriptor
//   wgmma_fence / wgmma_commit / wgmma_wait<N>
//                        wgmma.fence (registers written before it are
//                        seen by the wgmmas after it), commit_group,
//                        wait_group N (all but the newest N groups done)
//   fence_operand        keeps the compiler from moving accesses of a
//                        register across the surrounding wgmma primitives
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

#if defined(PMHC_CUDA_EMU) && !defined(__CUDA_ARCH__)
// element (row, k) of a K-major bf16 operand, decoded from its descriptor
// as the card reads it
inline float emu_desc_elem(uint64_t desc, int row, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3fffu) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fffu) << 4;
  if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0) std::abort();  // only the 128B swizzle, base offset 0
  uint32_t addr = start + (uint32_t)(row / 8) * sbo + (uint32_t)(row % 8) * 128 + (uint32_t)k * 2;
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
                             : emu_desc_elem(op.desc_a, 16 * w4 + row, k);
        acc = fmaf(x, emu_desc_elem(op.desc_b, col, k), acc);  // bf16 x bf16 is exact in fp32
      }
      out[4 * i + e] = acc;
    }
  }
  __syncwarp();
  for (int e = 0; e < op.n / 2; ++e) op.d[e] = out[e];
}
#endif

__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
#elif defined(PMHC_CUDA_EMU)
  emu_wgmma_q.open.push_back(EmuWgmma{d, 64, nullptr, da, db, scale_d});
#endif
}

__device__ __forceinline__ void wgmma_64x16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
#elif defined(PMHC_CUDA_EMU)
  emu_wgmma_q.open.push_back(EmuWgmma{d, 16, a, 0, db, scale_d});
#endif
}

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
