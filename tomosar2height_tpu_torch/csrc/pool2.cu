// Local pooling and plane scatter of point features: the Hopper versions of
// the three chunk-grid Pallas kernels in tomosar2height_tpu/ops/pallas/pool2_kernel.py.
//
//   K1 + K2 pool_runs    <- _reduce_kernel (:46) then _gather_kernel (:133), as
//                           _chunkgrid_pool_jit (:221) runs them: pool2's forward
//                           (max / mean / sum) and its backward (pool2_bwd, :492)
//   K2 t2h_pool_gather   <- _gather_kernel (:133) as _scatter_plane2_bwd (:424)
//                           runs it: each row reads a row-major plane at its cell
//   K3 t2h_scatter_plane <- _scatter_plane_kernel (:263): scatter-mean into a
//                           row-major plane
//
// pool_runs: one launch, no atomics, no cell buffer. Contract: in each batch
// entry the rows that hold one cell id, and so the cell's valid rows, are
// contiguous (the mask may clear rows among them), as on the aligned layout
// (tomosar2height_tpu_torch/ops/sorted_scatter.py, host_morton_bucket_aligned:
// rows Morton-sorted within each batch entry, PAD_CELL_SENTINEL pads only at
// tile ends), so each cell's rows form one run. The kernel defines a run as a
// maximal range of consecutive rows with one in-range cell id; a cell whose
// rows come in two runs is pooled as two cells (no check: unsorted input is
// the plain version's). Per row i:
//   out[i] = reduce over the valid rows j of run(i) of x[j]   (i valid)
//   out[i] = 0                                               (i not valid)
// valid = mask && 0 <= cell < ncell; max of a run with no valid row is never
// read; mean divides by the run's valid count; with the tie gate (max
// pooling's backward, x = g) a row keeps the run's sum only where
// tie_a[i] == tie_b[i] (values == pooled output), else 0.
//
// Partition: warp w of batch entry b owns the span of kSpan = 32 rows
// [32 w, 32 w + 32) (one ballot), lanes on features (a row of 32 f32 is one
// 128-byte load). A run belongs to the warp whose span holds its first row
// (its head). The warp loads its own runs' rows of the span at once, reduces
// each run with a segmented scan in row order in registers, and, where its
// last run goes on past the span, reads on, 32 rows a step, to the run's end
// (a run may be longer than a span and cross many). Valid rows before the
// span's first head belong to an earlier warp's run and are written by it;
// every other row of the span (its own runs' rows, and every row that is not
// valid) is written by this warp. So each row is written once, and each sum
// is taken in row order: forward and backward are bit-equal run to run.
//
// Bound on the H100: bytes. The TPU kernels accumulate a tile's cells in VMEM
// over a sequential grid; here each row is read and written once, with no
// (B, cells, F) buffer: at B = 8, Npad = 20480, F = 32 that is values on the
// valid rows (a quarter of the rows are pads) + out + cells + mask = 37.7 MB,
// ~11 us at 3.35 TB/s (the tie gate reads values and out on the valid rows
// besides). A warp issues all loads of its span before it reduces, so it
// waits about two memory latencies (cell ids and mask, then rows).

#include "common.cuh"

namespace t2h {

constexpr int kSpan = 32;  // rows a warp owns (tests/test_torch_pool2_runs.py SPAN)
constexpr unsigned kFull = 0xffffffffu;

// kind: 0 = max, 1 = mean, 2 = sum.
template <int KIND>
__device__ __forceinline__ float run_identity() {
  return KIND == 0 ? __uint_as_float(0xff800000u) : 0.0f;  // -inf or 0
}

template <int KIND>
__device__ __forceinline__ float run_combine(float acc, float v) {
  return KIND == 0 ? fmaxf(acc, v) : acc + v;
}

// A max needs no count: a run with no valid row has no row that takes its value.
template <int KIND>
__device__ __forceinline__ float run_finalize(float acc, int count) {
  return KIND == 1 ? acc / static_cast<float>(count > 1 ? count : 1) : acc;
}

// One 32-row step of a run's walk past its head's span: *len = how many rows
// from j0 on still hold cell c (32: the run goes on); returns their valid bits.
__device__ __forceinline__ unsigned run_step(const int* __restrict__ cb,
                                             const uint8_t* __restrict__ mb, int j0,
                                             int N, int c, int lane, int* len) {
  const int j = j0 + lane;
  const unsigned same = __ballot_sync(kFull, j < N && cb[j] == c);
  *len = same == kFull ? kSpan : __ffs(~same) - 1;
  return __ballot_sync(kFull, lane < *len && mb[j] != 0);
}

// TIE: the max-pool backward's gate (KIND 2 only). A warp's lanes take 32
// features of every row; F > 32 loops over feature chunks. Three blocks an SM
// (<= 80 registers) without the gate; with it, two (its 96 loads in flight
// take 128 registers, and spill under 80).
template <int KIND, bool TIE>
__global__ void __launch_bounds__(kThreads, TIE ? 2 : 3)
pool_runs(const float* __restrict__ x, const int* __restrict__ cells,
          const uint8_t* __restrict__ mask, const float* __restrict__ tie_a,
          const float* __restrict__ tie_b, float* __restrict__ out, int B, int N,
          int F, int ncell) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int spans = (N + kSpan - 1) / kSpan;
  if (warp >= (long long)B * spans) return;  // warp-uniform
  const long long b = warp / spans;
  const int s0 = static_cast<int>(warp - b * spans) * kSpan;
  const long long base = b * N;  // first row of batch entry b
  const int* cb = cells + base;
  const uint8_t* mb = mask + base;

  // lane = row of the span; -1 (no cell) past the end; the neighbours' ids by
  // shuffles, lanes 0 and 31 read the rows beside the span
  const int row = s0 + lane;
  const bool in = row < N;
  const int c = in ? cb[row] : -1;
  const bool m = in && mb[row] != 0;
  int edge = -1;
  if (lane == 0 && s0 > 0) edge = cb[s0 - 1];
  if (lane == kSpan - 1 && row + 1 < N) edge = cb[row + 1];
  int cprev = __shfl_up_sync(kFull, c, 1);
  int cnext = __shfl_down_sync(kFull, c, 1);
  if (lane == 0) cprev = edge;
  if (lane == kSpan - 1) cnext = edge;
  const bool ok = c >= 0 && c < ncell;
  const unsigned heads = __ballot_sync(kFull, ok && cprev != c);
  const unsigned same_next = __ballot_sync(kFull, ok && cnext == c);
  // a run's last row in the span: the next row holds another cell, or lane 31
  const unsigned ends = __ballot_sync(kFull, ok && (cnext != c || lane == kSpan - 1));
  const unsigned valid = __ballot_sync(kFull, ok && m);
  const unsigned before = heads ? (heads & (0u - heads)) - 1u : kFull;  // below the first head
  const unsigned own = valid & ~before;  // valid rows of runs headed in this span
  const bool cont = (same_next & ~before) >> (kSpan - 1);  // the last run goes on
  const int c_last = __shfl_sync(kFull, c, kSpan - 1);
  // lane k: the valid rows of the run that ends at row k, from its head on
  const unsigned upto = lane == kSpan - 1 ? kFull : (2u << lane) - 1u;
  const unsigned hb = heads & upto;
  const int run_count = __popc(own & upto & ~(hb ? (1u << (31 - __clz(hb))) - 1u : 0u));

  for (int f0 = 0; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    const bool fin = f < F;
    const float* xf = x + base * F + f;
    const float* af = TIE ? tie_a + base * F + f : nullptr;
    const float* bf = TIE ? tie_b + base * F + f : nullptr;
    // every load of the span first (with the gate's, into arrays of their
    // own: compared as they arrive, they came one latency after another)
    float v[kSpan], ta[TIE ? kSpan : 1], tb[TIE ? kSpan : 1];
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const long long i = (long long)(s0 + k) * F;
      const bool load = fin && (own >> k & 1u);
      v[k] = load ? xf[i] : 0.0f;
      if (TIE) {
        ta[k] = load ? af[i] : 0.0f;
        tb[k] = load ? bf[i] : 0.0f;
      }
    }
    unsigned tied = 0;  // TIE: bit k where tie_a == tie_b on row s0 + k
    if (TIE) {
#pragma unroll
      for (int k = 0; k < kSpan; ++k) tied |= (ta[k] == tb[k] ? 1u : 0u) << k;
    }

    // segmented inclusive scan in row order: v[k] = the run's partial at row k
    float acc = run_identity<KIND>();
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      if (heads >> k & 1u) acc = run_identity<KIND>();
      if (own >> k & 1u) acc = run_combine<KIND>(acc, v[k]);
      v[k] = acc;
    }

    // the last run past the span, in row order
    int tail_rows = 0, tail_count = 0;
    if (cont) {
      for (int len = kSpan; len == kSpan; tail_rows += len) {
        const int j0 = s0 + kSpan + tail_rows;
        const unsigned tv = run_step(cb, mb, j0, N, c_last, lane, &len);
#pragma unroll
        for (int k = 0; k < kSpan; ++k)
          if (fin && (tv >> k & 1u)) acc = run_combine<KIND>(acc, xf[(long long)(j0 + k) * F]);
        tail_count += __popc(tv);
      }
    }

    // backward fill: every row of a run gets the run's result
    float cur = 0.0f;
#pragma unroll
    for (int k = kSpan - 1; k >= 0; --k) {
      if (ends >> k & 1u) {
        int count = __shfl_sync(kFull, run_count, k);
        float a = v[k];
        if (k == kSpan - 1 && cont) {
          a = acc;
          count += tail_count;
        }
        cur = run_finalize<KIND>(a, count);
      }
      v[k] = cur;
    }

    float* of = out + base * F + f;
    if (fin) {
#pragma unroll
      for (int k = 0; k < kSpan; ++k) {
        const long long i = (long long)(s0 + k) * F;
        const bool mine = own >> k & 1u;
        if (s0 + k >= N || (!mine && (valid >> k & 1u))) continue;  // an earlier run's row
        float o = mine ? v[k] : 0.0f;
        if (TIE && !(tied >> k & 1u)) o = 0.0f;
        of[i] = o;
      }
    }
    if (cont) {  // the last run's rows past the span
      const float r = v[kSpan - 1];
      for (int done = 0, len = kSpan; len == kSpan; done += len) {
        const int j0 = s0 + kSpan + done;
        const unsigned tv = run_step(cb, mb, j0, N, c_last, lane, &len);
#pragma unroll
        for (int k = 0; k < kSpan; ++k) {
          if (!fin || !(tv >> k & 1u)) continue;
          const long long i = (long long)(j0 + k) * F;
          of[i] = TIE && af[i] != bf[i] ? 0.0f : r;
        }
      }
    }
  }
}

// Each valid row reads the row-major plane (B, reso, reso, F) at its Morton
// cell, divided by max(count, 1); 0 on the other rows.
__global__ void pool_gather(const float* __restrict__ plane, const int* __restrict__ cells,
                            const uint8_t* __restrict__ mask,
                            const int* __restrict__ counts, float* __restrict__ out,
                            int N, int F, int reso, long long total) {
  const int ncell = reso * reso;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long p = t / F;
    const int f = static_cast<int>(t - p * F);
    const int cell = cells[p];
    float v = 0.0f;
    if (mask[p] && cell >= 0 && cell < ncell) {
      const long long row = p / N * ncell + morton_to_rowmajor(cell, reso);
      const int c = counts[row];
      v = plane[row * F + f] / static_cast<float>(c > 1 ? c : 1);
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

// x (B,N,F) f32, cells (B,N) i32 Morton ids (each cell's rows contiguous),
// mask (B,N) u8 -> out (B,N,F): each valid row gets its run's
// max (kind 0), mean (1) or sum (2), the other rows 0. tie_a/tie_b (B,N,F)
// or both null: with them (kind 2 only) a row keeps its value only where
// tie_a == tie_b. One launch.
int t2h_pool_runs(const float* x, const int* cells, const uint8_t* mask, const float* tie_a,
                  const float* tie_b, float* out, int B, int N, int F, int ncell, int kind,
                  cudaStream_t stream) {
  const bool tie = tie_a != nullptr;
  if (kind < 0 || kind > 2 || tie != (tie_b != nullptr) || (tie && kind != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (long long)B * ((N + kSpan - 1) / kSpan) * 32;
  if (threads == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
#define T2H_RUNS(K, T)                                                                 \
  pool_runs<K, T><<<blocks, kThreads, 0, stream>>>(x, cells, mask, tie_a, tie_b, out, B, N, \
                                                   F, ncell)
  if (tie) T2H_RUNS(2, true);
  else if (kind == 0) T2H_RUNS(0, false);
  else if (kind == 1) T2H_RUNS(1, false);
  else T2H_RUNS(2, false);
#undef T2H_RUNS
  return static_cast<int>(cudaGetLastError());
}

// plane (B,reso,reso,F) row-major, cells (B,N) Morton ids, mask (B,N), counts
// (B,reso,reso) -> out (B,N,F) = plane[cell] / max(count,1); 0 on pad rows.
int t2h_pool_gather(const float* plane, const int* cells, const uint8_t* mask,
                    const int* counts, float* out, int B, int N, int F, int reso,
                    cudaStream_t stream) {
  const long long np = (long long)B * N * F;
  if (np > 0)
    pool_gather<<<grid_for(np), kThreads, 0, stream>>>(plane, cells, mask, counts, out, N,
                                                       F, reso, np);
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
