// Morton-tile scatter-mean into a row-major plane: the Hopper version of
// K14, _scatter_v3_kernel (pallas_scatter_mean_plane_v3) in
// tomosar2height_tpu/ops/pallas/scatter_kernel.py, on no model path. It is
// the last kernel in this file, and its next step is csrc/pool2.cu's
// scatter_runs with a tile-offset step of 4^level, as K11-K13 took.
//
// (K11 _scatter_tile_kernel_plane, K12 _aligned_scatter_kernel and K13
// _scatter_tile_kernel, the same function on the plain sorted layout, on the
// aligned tile offsets at a level and into the Morton cell vector, run on
// csrc/pool2.cu's scatter_runs: no atomics, each cell written once, bit-equal
// run to run.)
//
// The function: rows come grouped by 16x16 Morton tile (256 cells), each
// tile's rows contiguous, [toff[t], toff[t+1]); a row adds its values to cell
// (cell >> shift) - 256 t of its tile when that lies in [0, 256), else
// nothing (pad rows, PAD_CELL_SENTINEL, rows of a neighbouring tile); each
// cell's mean is written, 0 for an empty cell. K14 takes its tile offsets
// from the finest ones, every 4^level-th (toff_step).
//
// The TPU kernel builds one-hot matrices and contracts them on the MXU, a
// chunk of 128 rows at a time over a sequential grid. Here a block owns one
// (tile, batch entry, 32-feature chunk): its warps walk the tile's rows (warp
// w takes rows w, w + 8, ...; lane = feature), add them into a 256 x 32
// shared-memory accumulator and the cell counts with shared atomics, and the
// block writes its 256 cells once. A block owns its cells, so there are no
// global atomics and no zero-fill. The sums are not bit-reproducible run to
// run: the eight warps add into a cell in no fixed order (float addition is
// not associative); the counts are exact.
//
// Bound on the H100: bytes. Each input row is read once (F floats and its
// cell id) and each output cell written once: at the flagship's 256^2 level
// (B=8, ~33k aligned rows each, F=32) ~35 MB read and 67 MB written, ~30 us
// at 3.35 TB/s. A warp reads one row's 32 features as one 128-byte line; four
// rows are loaded before their adds so that loads stay in flight.

#include "common.cuh"

namespace t2h {

constexpr int kTileCells = 256;  // cells of a 16 x 16 Morton tile
constexpr int kFc = 32;          // features per block (one warp-wide row)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
tile_scatter_mean(const float* __restrict__ values, const int* __restrict__ cells,
                  const int* __restrict__ toff, float* __restrict__ out, int N, int F,
                  int R, int shift, int toff_row, int toff_step) {
  __shared__ float acc[kTileCells][kFc];
  __shared__ int cnt[kTileCells];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.z * kFc;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int f = f0 + lane;
  for (int e = tid; e < kTileCells * kFc; e += kThreads) acc[e / kFc][e % kFc] = 0.0f;
  if (tid < kTileCells) cnt[tid] = 0;
  __syncthreads();

  const int* to = toff + (long long)b * toff_row;
  const int start = to[(long long)t * toff_step];
  const int end = to[(long long)(t + 1) * toff_step];
  const int base = t * kTileCells;
  const long long rowb = (long long)b * N;
  for (int r0 = start + warp; r0 < end; r0 += kWarps * kUnroll) {
    int loc[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      loc[u] = -1;
      v[u] = 0.0f;
      if (r < end) {
        const int l = (cells[rowb + r] >> shift) - base;
        if (static_cast<unsigned>(l) < kTileCells) {
          loc[u] = l;
          if (f < F) v[u] = values[(rowb + r) * F + f];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (loc[u] < 0) continue;
      if (f < F) atomicAdd(&acc[loc[u]][lane], v[u]);
      if (lane == 0) atomicAdd(&cnt[loc[u]], 1);
    }
  }
  __syncthreads();

  float* ob = out + (long long)b * R * R * F;
  for (int e = tid; e < kTileCells * kFc; e += kThreads) {
    const int q = e / kFc;
    const int l = e - q * kFc;
    if (f0 + l >= F) continue;
    const int c = cnt[q];
    const int dst = morton_to_rowmajor(base + q, R);
    ob[(long long)dst * F + f0 + l] = acc[q][l] / static_cast<float>(c > 1 ? c : 1);
  }
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// values (B,N,F) f32, cells (B,N) i32 Morton ids (finest, or at this
// resolution with shift 0), tile offsets: tile t of entry b spans rows
// [toff[b*toff_row + t*toff_step], toff[b*toff_row + (t+1)*toff_step]) ->
// out (B,R,R,F) row-major. R*R must be a multiple of 256.
int t2h_tile_scatter_mean(const float* values, const int* cells, const int* toff,
                          float* out, int B, int N, int F, int R, int shift,
                          int toff_row, int toff_step, cudaStream_t stream) {
  const int tiles = R * R / kTileCells;
  if ((long long)B * tiles * F > 0) {
    const dim3 grid(tiles, B, (F + kFc - 1) / kFc);
    tile_scatter_mean<<<grid, kThreads, 0, stream>>>(values, cells, toff, out, N, F, R,
                                                     shift, toff_row, toff_step);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
