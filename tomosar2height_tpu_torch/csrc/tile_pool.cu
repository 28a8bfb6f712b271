// Fused local pooling on the Morton-aligned layout with 16x16-cell tiles: the
// Hopper version of _pool_kernel in tomosar2height_tpu/ops/pallas/pool_kernel.py
// (launched by _pool_impl; pallas_tile_pool, sorted_impl='fused').
//
// The function (reference pool_local, pointnet.py:92-99): every row of tile
// t's range [toff[t], toff[t+1]) whose finest Morton id lies in the tile's
// 256 cells reduces into its cell (max or mean; K1's rule: an empty cell is
// 0), and then reads its cell's value back. Rows whose id lies outside the
// tile (PAD_CELL_SENTINEL pads) read 0, and so do the rows past the last
// tile's range, which the TPU kernel leaves undefined.
//
// The TPU kernel reduces each 128-row chunk with a segmented prefix scan (max)
// or a one-hot matmul (mean) on the MXU over a sequential grid, then gathers
// back with another one-hot matmul. Here a block owns one (tile, batch entry,
// 32-feature chunk) and keeps the tile's 256 x 32 cell values in shared
// memory: pass 1 walks the tile's rows (warp w takes rows w, w + 8, ...; lane
// = feature) with shared atomics, K1's integer-bits atomic max or an add;
// pass 2 walks them again and writes each row's cell value. One launch per
// call, no global atomics. Max is exact (order-free); the mean's sums are not
// bit-reproducible run to run (the warps add in no fixed order).
//
// Bound on the H100: bytes. Each row's F floats are read once and written
// once: at the flagship (B=8, ~33k aligned rows each, F=32) ~35 MB each way,
// ~20 us at 3.35 TB/s. The second pass re-reads the tile's cell ids (4 bytes
// a row) but not its values.

#include "common.cuh"

namespace t2h {

constexpr int kPoolCells = 256;  // cells of a 16 x 16 Morton tile
constexpr int kPoolFc = 32;      // features per block
constexpr int kPoolWarps = kThreads / 32;

// kind: 0 = max, 1 = mean.
__global__ void __launch_bounds__(kThreads)
tile_pool_kernel(const float* __restrict__ values, const int* __restrict__ cells,
                 const int* __restrict__ toff, float* __restrict__ out, int N, int F,
                 int T, int kind) {
  __shared__ float acc[kPoolCells][kPoolFc];
  __shared__ int cnt[kPoolCells];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.z * kPoolFc;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int f = f0 + lane;
  const float init = kind == 0 ? __uint_as_float(0xff800000u) : 0.0f;  // -inf or 0
  for (int e = tid; e < kPoolCells * kPoolFc; e += kThreads)
    acc[e / kPoolFc][e % kPoolFc] = init;
  if (tid < kPoolCells) cnt[tid] = 0;
  __syncthreads();

  const int* to = toff + (long long)b * (T + 1);
  const int start = to[t];
  const int end = to[t + 1];
  const int base = t * kPoolCells;
  const long long rowb = (long long)b * N;
  // pass 1: reduce the tile's rows into their cells
  for (int r = start + warp; r < end; r += kPoolWarps) {
    const int l = cells[rowb + r] - base;
    if (static_cast<unsigned>(l) >= kPoolCells) continue;
    if (f < F) {
      const float v = values[(rowb + r) * F + f];
      if (kind == 0) {
        atomic_max_f32(&acc[l][lane], v);
      } else {
        atomicAdd(&acc[l][lane], v);
      }
    }
    if (lane == 0) atomicAdd(&cnt[l], 1);
  }
  __syncthreads();
  for (int e = tid; e < kPoolCells * kPoolFc; e += kThreads) {
    const int q = e / kPoolFc;
    const int c = cnt[q];
    float& a = acc[q][e % kPoolFc];
    if (kind == 0) {
      a = c > 0 ? a : 0.0f;
    } else {
      a = a / static_cast<float>(c > 1 ? c : 1);
    }
  }
  __syncthreads();

  // pass 2: every row reads its cell back; the last tile's blocks also write
  // 0 to the rows past its range
  const int stop = t == T - 1 ? N : end;
  if (f < F) {
    for (int r = start + warp; r < stop; r += kPoolWarps) {
      float v = 0.0f;
      if (r < end) {
        const int l = cells[rowb + r] - base;
        if (static_cast<unsigned>(l) < kPoolCells) v = acc[l][lane];
      }
      out[(rowb + r) * F + f] = v;
    }
  }
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// values (B,N,F) f32, cells (B,N) i32 finest Morton ids (PAD_CELL_SENTINEL on
// pads), toff (B,T+1) i32 row offsets of the T 256-cell tiles, kind 0 max /
// 1 mean -> out (B,N,F): each row's cell value, 0 on rows outside every
// tile's cells.
int t2h_tile_pool(const float* values, const int* cells, const int* toff, float* out,
                  int B, int N, int F, int T, int kind, cudaStream_t stream) {
  if ((long long)B * T * F > 0) {
    const dim3 grid(T, B, (F + kPoolFc - 1) / kPoolFc);
    tile_pool_kernel<<<grid, kThreads, 0, stream>>>(values, cells, toff, out, N, F, T,
                                                    kind);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
