// The 32-row block GEMM of the ALTO level kernels (K4 forward, K5 backward):
// a block owns kP = 32 points whose operand sits in shared memory k-major
// ([K][kP]); the weight matrix streams from global memory through two staged
// kKT x kNT shared tiles (double-buffered: the next tile's global loads fly
// while the current tile's FMAs run). Each of the 256 threads holds a 4-point
// x 4-column fp32 accumulator tile of a 32 x 128 output slab; a warp owns 16
// columns of all 32 points (lane = 8 row groups x 4 column groups), so its
// shared reads per step are 128 B of A and 64 B of W (2 wavefronts).
#pragma once

#include "common.cuh"

namespace t2h {

constexpr int kP = 32;    // points per block
constexpr int kNT = 128;  // output columns per pass
constexpr int kKT = 32;   // weight rows staged per step

constexpr int kStage = kKT * kNT / kThreads;  // weight values each thread stages

__device__ __forceinline__ void fma_step(float (&acc)[4][4], const float* A,
                                         const float* Wt, int k, int kk, int row0,
                                         int col0) {
  const float4 a = *reinterpret_cast<const float4*>(A + k * kP + row0);
  const float4 w = *reinterpret_cast<const float4*>(Wt + kk * kNT + col0);
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// acc[i][j] += sum_k A[k][row0+i] * W[k][n0+col0+j] for k < K.
// A: shared, k-major with row length kP. W: global row-major (K, N), staged
// through Ws[2][kKT][kNT]. Every thread of the block must call it (it
// synchronises); it ends with a barrier, so A may be overwritten after it.
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], const float* A, int K,
                                          const float* __restrict__ W, int N, int n0,
                                          float* Ws, int tid, int row0, int col0) {
  float stage[kStage];
  auto load = [&](int k0) {
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int e = tid + m * kThreads;
      const int k = k0 + e / kNT;
      const int n = n0 + e % kNT;
      stage[m] = (k < K && n < N) ? __ldg(W + (long long)k * N + n) : 0.0f;
    }
  };
  auto store = [&](float* buf) {
#pragma unroll
    for (int m = 0; m < kStage; ++m) buf[tid + m * kThreads] = stage[m];
  };
  const int ntiles = (K + kKT - 1) / kKT;
  load(0);
  store(Ws);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const float* cur = Ws + (t & 1) * (kKT * kNT);
    const int k0 = t * kKT;
    if (t + 1 < ntiles) load(k0 + kKT);
    if (K - k0 >= kKT) {
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) fma_step(acc, A, cur, k0 + kk, kk, row0, col0);
    } else {
      for (int kk = 0; kk < K - k0; ++kk) fma_step(acc, A, cur, k0 + kk, kk, row0, col0);
    }
    if (t + 1 < ntiles) store(Ws + ((t + 1) & 1) * (kKT * kNT));
    __syncthreads();
  }
}

}  // namespace t2h
