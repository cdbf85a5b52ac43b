// CPU emulation of the CUDA runtime subset that the port's kernels use,
// so that csrc/*.cu compile with g++ and run on the CPU in the tests
// (pmhc_tpu_torch/ops/_emulate.py builds them). Each CUDA thread of a
// block is a std::thread; __syncthreads and the warp operations are
// barriers; blocks run one after another; atomics are std::atomic_ref.
// Shared memory is filled with NaN before each block, so a read of a
// slot the kernel never wrote shows up in its results. What this cannot
// show: anything of the card's compiler (registers, spills, launch
// limits), timing, or races that a barrier here hides. PMHC_CUDA_EMU
// selects the emulated bodies of the PTX primitives (csrc/mma_bf16.cuh,
// csrc/wgmma.cuh); their runtime is here: the shared window's addresses
// (the block's shared memory starts at EMU_SMEM_BASE, 16-byte but not
// 1024-byte aligned, so a kernel that needs 1024-byte alignment must make
// it), the named barriers (bar.sync / bar.arrive with an id and a thread
// count) and each thread's queue of issued wgmma (run at wait_group).
#pragma once
#define PMHC_CUDA_EMU 1
#include <atomic>
#include <barrier>
#include <condition_variable>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <tuple>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct emu_uint3 { unsigned x, y, z; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

inline thread_local emu_uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline float* emu_smem_ptr = nullptr;
inline size_t emu_smem_floats = 0;
inline size_t emu_max_smem = 0;

// a named barrier: the threads that arrive in one phase, the count the
// phase waits for, and the phase number the waiters watch
struct EmuNamedBar {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0, expected = 0;
  unsigned phase = 0;
};

struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::barrier<>*> wbar;
  float shfl[32][32];
  uint32_t frag[32][32][6];  // per warp and lane: an mma's A (4) and B (2) registers
  EmuNamedBar nbar[16];
};
inline thread_local EmuBlock* emu_blk = nullptr;

// bar.sync (wait) / bar.arrive (no wait) on named barrier id of n threads;
// the threads of one phase must agree on n
inline void emu_named_bar(int id, int n, bool wait) {
  if (id < 0 || id >= 16 || n <= 0 || n % 32) std::abort();
  EmuNamedBar& b = emu_blk->nbar[id];
  std::unique_lock<std::mutex> lk(b.m);
  if (b.arrived == 0) b.expected = n;
  else if (b.expected != n) std::abort();
  const unsigned phase = b.phase;
  if (++b.arrived == n) {
    b.arrived = 0;
    ++b.phase;
    b.cv.notify_all();
    return;
  }
  if (wait) b.cv.wait(lk, [&] { return b.phase != phase; });
}

// the shared window: addresses of the emulated block's shared memory
inline constexpr uint32_t EMU_SMEM_BASE = 0x410;
inline uint32_t emu_smem_addr(const void* p) {
  return (uint32_t)(static_cast<const char*>(p) - reinterpret_cast<const char*>(emu_smem_ptr)) + EMU_SMEM_BASE;
}
inline void* emu_smem_at(uint32_t addr) { return reinterpret_cast<char*>(emu_smem_ptr) + (addr - EMU_SMEM_BASE); }

// an issued wgmma: D (n / 2 floats of this thread), its A fragment
// registers (or null: A through desc_a), B's descriptor, scale_d, and
// whether A and B are MN-major (transposed); queued until the wait_group
// that retires its group
struct EmuWgmma {
  float* d;
  int n;
  const uint32_t* a;
  uint64_t desc_a, desc_b;
  int scale_d;
  int ta, tb;
};
struct EmuWgmmaQueue {
  std::vector<EmuWgmma> open;               // issued since the last commit
  std::deque<std::vector<EmuWgmma>> groups;  // committed, oldest first
};
inline thread_local EmuWgmmaQueue emu_wgmma_q;

inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_blk->wbar[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int s) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_blk->shfl[w][l] = v;
  __syncwarp();
  const float r = emu_blk->shfl[w][l ^ s];
  __syncwarp();
  return r;
}
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
// sm_90's vector atomics: each element added atomically
inline float2 atomicAdd(float2* p, float2 v) {
  return {atomicAdd(&p->x, v.x), atomicAdd(&p->y, v.y)};
}
inline float4 atomicAdd(float4* p, float4 v) {
  return {atomicAdd(&p->x, v.x), atomicAdd(&p->y, v.y), atomicAdd(&p->z, v.z), atomicAdd(&p->w, v.w)};
}
inline unsigned atomicAdd(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_add(v); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float __fmul_rn(float a, float b) { return a * b; }  // never contracted on the card
inline float __ldg(const float* p) { return *p; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int min(int a, int b) { return a < b ? a : b; }

struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a card of 3 SMs: persistent kernels loop over several rows per block
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  if ((size_t)bytes > emu_max_smem) emu_max_smem = bytes;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return cudaSuccess; }

template <typename... P, size_t... I>
std::tuple<std::decay_t<P>...> emu_unpack(void** args, std::index_sequence<I...>) {
  return std::tuple<std::decay_t<P>...>(*static_cast<std::decay_t<P>*>(args[I])...);
}

template <typename... P>
cudaError_t cudaLaunchKernel(void (*f)(P...), dim3 grid, dim3 block, void** args, size_t smem, cudaStream_t) {
  if (smem > 48 * 1024 && smem > emu_max_smem) return cudaErrorInvalidValue;  // opt-in missing
  if (smem > emu_smem_floats * 4) return cudaErrorInvalidValue;
  auto vals = emu_unpack<P...>(args, std::index_sequence_for<P...>{});
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x;
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    for (size_t k = 0; k < emu_smem_floats; ++k) emu_smem_ptr[k] = NAN;  // catch unwritten reads
    EmuBlock blk;
    std::barrier<> bar(nt);
    blk.bar = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> wb;
    for (unsigned w = 0; w < (nt + 31) / 32; ++w) {
      wb.emplace_back(new std::barrier<>(std::min(32u, nt - 32 * w)));
      blk.wbar.push_back(wb.back().get());
    }
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; ++t) {
      ts.emplace_back([&, t, bx] {
        threadIdx = {t, 0, 0};
        blockIdx = {bx, 0, 0};
        emu_blk = &blk;
        std::apply(f, vals);
      });
    }
    for (auto& th : ts) th.join();
  }
  return cudaSuccess;
}
