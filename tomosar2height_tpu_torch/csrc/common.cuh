// Shared helpers of the port's CUDA kernels (built for sm_90a, plain C ABI).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace t2h {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

// Blocks for a grid-stride loop over n elements.
inline unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 16)) blocks = 1LL << 16;
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

// Whether p is 16-byte aligned (a 16-byte copy's or the TMA's alignment).
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Every other bit of v (bit 2k -> bit k): the x half of a Morton code.
__device__ __forceinline__ int compact1by1(int v) {
  unsigned int x = static_cast<unsigned int>(v) & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  x = (x | (x >> 8)) & 0x0000ffffu;
  return static_cast<int>(x);
}

// Morton cell id (x bits even, y bits odd) -> row-major index y * reso + x.
__device__ __forceinline__ int morton_to_rowmajor(int code, int reso) {
  return compact1by1(code >> 1) * reso + compact1by1(code);
}

// --- cp.async: 16 or 4 bytes from device to shared memory, bypassing the
// registers (src_bytes < the size zero-fills the rest) ---------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace t2h
