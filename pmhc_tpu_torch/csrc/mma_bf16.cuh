// Warp-level PTX primitives of the fused layer's Hopper design, one
// device function each. On the card the body is the PTX instruction
// (sm_80 and later; built for sm_90a). Under the CPU emulation of
// csrc/emu/ (PMHC_CUDA_EMU) the body follows the PTX ISA's fragment
// tables: the lanes of a warp exchange their fragments through the
// warp's scratch in EmuBlock between two __syncwarp()s, the way the
// emulated __shfl_xor_sync does.
//   mma_bf16_16816   D += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 C/D
//   pack_bf16x2      cvt.rn.bf16x2.f32: two floats rounded to nearest even
//                    into one register, the first argument in the low half
//   split_bf16x2     the --fast-f32 split of two floats into bf16 halves:
//                    hi = bf16_rn(x), lo = bf16_rn(x - hi), as two registers
//                    laid out as pack_bf16x2's (x - hi is exact in fp32, so
//                    hi + lo keeps ~16 significant bits of x)
//   mma_split_16816  D += A * B from split operands: hi*hi + hi*lo + lo*hi,
//                    three mma.sync (the lo*lo term, ~2^-16 relative, is
//                    dropped, as in the JAX package's mm_maker("high"))
//   cp_async16 / cp_async4, cp_async_commit, cp_async_wait_all
//                    global -> shared copies in flight while the block
//                    computes (emulated: a plain copy; the waits do nothing)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pmhc {

// Fragments of mma.m16n8k16 with .bf16 operands, g = lane / 4, c = lane % 4;
// each register holds two consecutive elements, the lower index in the low
// 16 bits:
//   A  a[0] = row g,     cols 2c, 2c+1      a[1] = row g + 8, cols 2c, 2c+1
//      a[2] = row g,     cols 2c+8, 2c+9    a[3] = row g + 8, cols 2c+8, 2c+9
//   B  b[0] = rows 2c, 2c+1 of col g        b[1] = rows 2c+8, 2c+9 of col g
//   D  d[0], d[1] = row g, cols 2c, 2c+1    d[2], d[3] = row g + 8, cols 2c, 2c+1
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4], const uint32_t b[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(PMHC_CUDA_EMU)
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t(*f)[6] = emu_blk->frag[w];
  for (int r = 0; r < 4; ++r) f[l][r] = a[r];
  f[l][4] = b[0];
  f[l][5] = b[1];
  __syncwarp();
  auto elem = [](uint32_t reg, int k) {
    return __bfloat162float(__nv_bfloat16{uint16_t(k % 2 ? reg >> 16 : reg & 0xffffu)});
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = l / 4 + 8 * (e / 2), col = 2 * (l % 4) + e % 2;
    float acc = d[e];
    for (int k = 0; k < 16; ++k) {
      const float x = elem(f[(row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k);
      const float y = elem(f[col * 4 + (k % 8) / 2][4 + k / 8], k);
      acc = fmaf(x, y, acc);  // bf16 x bf16 is exact in fp32
    }
    out[e] = acc;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
#endif
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
#elif defined(PMHC_CUDA_EMU)
  r = uint32_t(__float2bfloat16_rn(lo).x) | (uint32_t(__float2bfloat16_rn(hi).x) << 16);
#endif
  return r;
}

__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
#if defined(__CUDA_ARCH__)
  hi = pack_bf16x2(x0, x1);
  lo = pack_bf16x2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
#elif defined(PMHC_CUDA_EMU)
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = uint32_t(h0.x) | (uint32_t(h1.x) << 16);
  lo = uint32_t(__float2bfloat16_rn(x0 - __bfloat162float(h0)).x) |
       (uint32_t(__float2bfloat16_rn(x1 - __bfloat162float(h1)).x) << 16);
#endif
}

__device__ __forceinline__ void mma_split_16816(float d[4], const uint32_t ah[4], const uint32_t al[4],
                                                const uint32_t bh[2], const uint32_t bl[2]) {
  mma_bf16_16816(d, ah, bh);
  mma_bf16_16816(d, ah, bl);
  mma_bf16_16816(d, al, bh);
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1 (.cg)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
#elif defined(PMHC_CUDA_EMU)
  std::memcpy(smem, gmem, 16);
#endif
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
#elif defined(PMHC_CUDA_EMU)
  std::memcpy(smem, gmem, 4);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// this thread's copies have landed; a __syncthreads() after it shows them to the block
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

}  // namespace pmhc
