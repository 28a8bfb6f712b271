// Local pooling and plane scatter of point features: the Hopper versions of
// the three chunk-grid Pallas kernels in tomosar2height_tpu/ops/pallas/pool2_kernel.py.
//
//   K1 t2h_pool_reduce   <- _reduce_kernel        (per-cell max / mean / sum)
//   K2 t2h_pool_gather   <- _gather_kernel        (each point reads its cell back)
//   K3 t2h_scatter_plane <- _scatter_plane_kernel (scatter-mean into a row-major plane)
//
// The backwards of pool2 and scatter_plane2 run on K1 and K2 as the JAX
// custom_vjps do (pool2_kernel.py:424-453, :492-517): K1 'sum' gives the
// max-pool's per-cell cotangent sum; K2 with a row-major read and a per-cell
// count divisor gives the scatter-mean transpose g_plane[cell] / count.
//
// The TPU kernels walk a sequential (batch, 128-point chunk) grid and keep a
// tile's accumulator in VMEM, which is why they need the chunk metadata
// (ct/pt/tmask). Here blocks run in parallel in no order, so each kernel is
// one thread per (point, feature) with atomics into a (B, cells, F) buffer in
// device memory, then a finalize pass. Only the Morton cell ids and the mask
// are read; padding rows (mask 0, PAD_CELL_SENTINEL) reach no cell.
//
// Bound on the H100: bytes and atomics. At the flagship shapes (B=8, <=24576
// rows, F=32) a call moves ~6-25 MB plus a 64 MB cell buffer for K1, a few
// microseconds at 3.35 TB/s; a warp covers one point's 32 features, so its
// atomics hit 32 consecutive words of one cell row.

#include <limits>

#include "common.cuh"

namespace t2h {

// kind: 0 = max (start -inf, atomic max), 1 = mean, 2 = sum (start 0, atomic add).
__global__ void pool_reduce_accum(const float* __restrict__ values,
                                  const int* __restrict__ cells,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ acc, int* __restrict__ counts,
                                  int N, int F, int ncell, long long total, int kind) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long p = t / F;
    const int f = static_cast<int>(t - p * F);
    const int cell = cells[p];
    if (!mask[p] || cell < 0 || cell >= ncell) continue;
    const long long b = p / N;
    const long long row = b * ncell + cell;
    const float v = values[t];
    if (kind == 0) {
      atomic_max_f32(acc + row * F + f, v);
    } else {
      atomicAdd(acc + row * F + f, v);
    }
    if (f == 0) atomicAdd(counts + row, 1);
  }
}

// Empty cells become 0 (torch_scatter zero-init; -inf would poison later sums).
__global__ void pool_reduce_finalize(float* __restrict__ acc,
                                     const int* __restrict__ counts, long long n,
                                     int F, int kind) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const int c = counts[t / F];
    if (kind == 0) {
      acc[t] = c > 0 ? acc[t] : 0.0f;
    } else {
      acc[t] = acc[t] / static_cast<float>(c > 1 ? c : 1);
    }
  }
}

// reso > 0: cellv (and counts) are row-major planes of side reso, so the
// Morton id is converted first. counts != nullptr: divide by max(count, 1).
__global__ void pool_gather(const float* __restrict__ cellv,
                            const int* __restrict__ cells,
                            const uint8_t* __restrict__ mask,
                            const int* __restrict__ counts, float* __restrict__ out,
                            int N, int F, int ncell, int reso, long long total) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long p = t / F;
    const int f = static_cast<int>(t - p * F);
    const int cell = cells[p];
    float v = 0.0f;
    if (mask[p] && cell >= 0 && cell < ncell) {
      const long long b = p / N;
      const long long row = b * ncell + (reso > 0 ? morton_to_rowmajor(cell, reso) : cell);
      v = cellv[row * F + f];
      if (counts != nullptr) {
        const int c = counts[row];
        v = v / static_cast<float>(c > 1 ? c : 1);
      }
    }
    out[t] = v;
  }
}

__global__ void scatter_plane_accum(const float* __restrict__ values,
                                    const int* __restrict__ cells,
                                    const uint8_t* __restrict__ mask,
                                    float* __restrict__ plane, int* __restrict__ counts,
                                    int N, int F, int reso, long long total) {
  const int ncell = reso * reso;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long p = t / F;
    const int f = static_cast<int>(t - p * F);
    const int cell = cells[p];
    if (!mask[p] || cell < 0 || cell >= ncell) continue;
    const long long b = p / N;
    const long long row = b * ncell + morton_to_rowmajor(cell, reso);
    atomicAdd(plane + row * F + f, values[t]);
    if (f == 0) atomicAdd(counts + row, 1);
  }
}

}  // namespace t2h

using namespace t2h;

extern "C" {

const char* t2h_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values (B,N,F) f32, cells (B,N) i32 Morton ids, mask (B,N) u8 ->
// cellv (B,ncell,F) f32 in Morton order, counts (B,ncell) i32.
int t2h_pool_reduce(const float* values, const int* cells, const uint8_t* mask,
                    float* cellv, int* counts, int B, int N, int F, int ncell,
                    int kind, cudaStream_t stream) {
  const long long nv = (long long)B * ncell * F;
  const long long nc = (long long)B * ncell;
  const long long np = (long long)B * N * F;
  if (nv > 0) {
    fill_f32<<<grid_for(nv), kThreads, 0, stream>>>(
        cellv, nv, kind == 0 ? -std::numeric_limits<float>::infinity() : 0.0f);
    fill_i32<<<grid_for(nc), kThreads, 0, stream>>>(counts, nc, 0);
  }
  if (np > 0)
    pool_reduce_accum<<<grid_for(np), kThreads, 0, stream>>>(
        values, cells, mask, cellv, counts, N, F, ncell, np, kind);
  if (nv > 0 && kind != 2)  // a sum needs no finalize: empty cells stay 0
    pool_reduce_finalize<<<grid_for(nv), kThreads, 0, stream>>>(cellv, counts, nv,
                                                                 F, kind);
  return static_cast<int>(cudaGetLastError());
}

// cellv (B,ncell,F) in Morton order (reso 0) or a row-major (B,reso,reso,F)
// plane (reso > 0), cells (B,N) Morton ids, mask (B,N), counts (B,ncell) or
// null -> out (B,N,F) = cellv[cell] (/ max(count,1)); 0 on pad rows.
int t2h_pool_gather(const float* cellv, const int* cells, const uint8_t* mask,
                    const int* counts, float* out, int B, int N, int F, int ncell,
                    int reso, cudaStream_t stream) {
  const long long np = (long long)B * N * F;
  if (np > 0)
    pool_gather<<<grid_for(np), kThreads, 0, stream>>>(cellv, cells, mask, counts, out,
                                                       N, F, ncell, reso, np);
  return static_cast<int>(cudaGetLastError());
}

// values (B,N,F), cells (B,N) Morton ids at `reso`, mask (B,N) ->
// plane (B,reso,reso,F) row-major scatter-mean, counts (B,reso,reso) i32.
int t2h_scatter_plane(const float* values, const int* cells, const uint8_t* mask,
                      float* plane, int* counts, int B, int N, int F, int reso,
                      cudaStream_t stream) {
  const long long nc = (long long)B * reso * reso;
  const long long nv = nc * F;
  const long long np = (long long)B * N * F;
  if (nv > 0) {
    fill_f32<<<grid_for(nv), kThreads, 0, stream>>>(plane, nv, 0.0f);
    fill_i32<<<grid_for(nc), kThreads, 0, stream>>>(counts, nc, 0);
  }
  if (np > 0)
    scatter_plane_accum<<<grid_for(np), kThreads, 0, stream>>>(
        values, cells, mask, plane, counts, N, F, reso, np);
  if (nv > 0)
    divide_by_counts<<<grid_for(nv), kThreads, 0, stream>>>(plane, counts, nv, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
