// Local pooling and plane scatter of point features: the Hopper versions of
// the three chunk-grid Pallas kernels in tomosar2height_tpu/ops/pallas/pool2_kernel.py,
// of the aligned tile pool of pool_kernel.py, of the four tile scatter-means of
// scatter_kernel.py, and of the plane scatter of level_kernel.py's K4.
//
//   K1 + K2 pool_runs    <- _reduce_kernel (:46) then _gather_kernel (:133), as
//                           _chunkgrid_pool_jit (:221) runs them: pool2's forward
//                           (max / mean / sum) and its backward (pool2_bwd, :492)
//   K10 pool_runs        <- pool_kernel.py _pool_kernel (:36): the same reduce and
//                           gather-back over the aligned layout's 256-cell tiles,
//                           a row pooling only inside its tile (TILED); and its
//                           backward (fused.py _tile_pool_bwd, :118): max's
//                           cotangent split evenly among a run's tied rows
//                           (kind 3), mean's the run mean of the cotangent
//   K2 pool_gather       <- _gather_kernel (:133) as _scatter_plane2_bwd (:424)
//                           runs it: each row reads a row-major plane at its
//                           cell, a warp a 32-row span, each run's cell read once;
//                           K12's backward (fused.py _tile_scatter_bwd, :149)
//                           the same at a coarser level (cell = id >> shift)
//   K3 scatter_runs      <- _scatter_plane_kernel (:263): masked scatter-mean
//                           into a row-major plane, with the cells' counts
//   K12 scatter_runs     <- scatter_kernel.py _aligned_scatter_kernel (:242):
//                           the same over the aligned layout's 256-cell tiles at
//                           a coarser level, a row adding only inside its tile
//   K11 scatter_runs     <- scatter_kernel.py _scatter_tile_kernel_plane (:124):
//                           K12's function on the plain sorted layout, the tile
//                           offsets every 256th of the per-cell offsets
//   K13 scatter_runs     <- scatter_kernel.py _scatter_tile_kernel (:65): K11's
//                           function into the Morton-ordered cell vector
//                           (B, reso^2, F) (MORTON)
//   K14 scatter_runs     <- scatter_kernel.py _scatter_v3_kernel (:495): K12's
//                           function, the tile offsets every 4^level-th of
//                           the finest ones
//   K4's plane           <- level_kernel.py _level_kernel (:110), its masked
//   scatter_runs            scatter-mean of the level's point features
//                           (c_out, csrc/level.cu) at the level's shift, with
//                           the counts, as K3
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
// valid = 0 <= cell < ncell and, K1 + K2: mask; K10 (TILED, no mask): the row
// lies in the row range [toff[t], toff[t + 1]) of the 256-cell tile t = cell >> 8
// (pads, rows of another tile and rows past the last tile are not valid).
// A max of a run with no valid row is never read; mean divides by the run's
// valid count; with the tie gate (max
// pooling's backward, x = g) a row keeps the run's sum only where
// tie_a[i] == tie_b[i] (values == pooled output), else 0: kind 2 (pool2's
// backward, JAX pool2_kernel.py:492) gives each tied row the whole sum, kind 3
// (K10's backward, the vjp of segment_max, fused.py:118) divides it by the
// number of the run's valid rows that tie, feature by feature.
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
// besides; K10 reads B * (T + 1) tile offsets, which stay in L1, in place of
// the mask). A warp issues all loads of its span before it reduces, so it
// waits about two memory latencies (cell ids and mask, then rows).

// scatter_runs (K3, K4's plane, K11-K14): the same partition, writing each run's
// mean to its cell of a row-major plane (B, reso, reso, F) (K13: of the
// Morton-ordered cell vector (B, reso^2, F)) instead of back to its rows.
// A row's cell is cells >> shift at this resolution (K3, K11, K13: shift 0);
// it is in range when cells >= 0 and the cell < reso^2. A row is valid when,
// besides, K3 and K4: its mask is set; K11-K14 (TILED): the row lies in the
// row range [toff[t * step], toff[(t + 1) * step]) of the 256-cell tile t =
// cell >> 8 that holds its cell (K12: step 1, tile offsets at this
// resolution; K11, K13: step 256, the per-cell offsets read in place; K14:
// step 4^level, the finest tile offsets read in place; a pad,
// PAD_CELL_SENTINEL on the aligned layout, reso^2 on the plain sorted one, is
// never in range). Runs are
// as above, on the cell at this resolution. On the fused layout (256-cell
// finest tiles, pads only at finest-tile ends) a cell at level l <= 4 covers 4^l
// finest cells inside one finest tile, so its rows are contiguous and no pad
// falls among them: each occupied cell is one run down to 16^2
// (tests/test_torch_scatter_runs.py holds this at 16^2; on fused2's layout,
// 1024-cell finest tiles, K4's levels down to 32^2 the same,
// tests/test_torch_level_runs.py); on the plain sorted
// layout (Morton-sorted rows, pads at the end) every cell is one run. A run
// with a valid row writes its cell's mean (K3: and count) once, by the warp of
// its head, from its row-order sum; a run with none writes nothing.
// Three steps in one stream: the flags (B * reso^2 bytes) are cleared; the
// mark pass sets the flag of every cell that holds a valid row (a thread a
// row, all storing 1); then one launch whose blocks alternate between the
// run part (the occupied cells) and the zero part (0 to every cell, and
// count, whose flag is clear), so the latency-bound walk of the runs and the
// bandwidth-bound zeros (most of the plane: >= 75% of the cells at 256^2)
// overlap, and no warp walks a gap of empty cells. Each plane cell and each
// count is written once; no float atomic; bit-equal run to run. Cell ids
// cannot be binary-searched (pads carry the sentinel mid-entry), so every
// row's id is read. The run part's grid is sized by spans x feature chunks,
// not by tiles, so a level of few tiles (32^2, 16^2) gets as many warps as
// 256^2; a lane takes 1, 2 or 4 features (F < 64, < 128, from 128 on).
//
// Bound on the H100: bytes: values on the valid rows, every row's cell id (and
// mask, K3; tile offsets, K11-K13), the plane and counts written once (+ the
// flags). K3 at B = 8, Npad = 20480, F = 32: ~16 MB of values and ~67 MB of
// plane, ~26 us at 3.35 TB/s; the zeros are most of it.
//
// bf16 (the model's bf16 dtype): pool_runs, pool_gather and scatter_runs
// are templated on the value type T (dtype.cuh). A bf16 instance reads bf16
// values (scatter_runs: 2, 4 or 8 bytes a lane), sums or maxes them in f32
// registers in the same row order as the f32 instance, and rounds each
// output to bf16 once, where it stores it: the JAX kernels' bf16 rule
// (pool2_kernel.py:88-117 f32 accumulators cast to the dtype, :148-158 the
// gather in the dtype, :292-334 the plane mean in f32 written in the dtype,
// :424-453 (g / count) rounded then gathered, :514 the tie gate in f32).
// Counts stay int32; the bytes of the values and outputs halve.

#include "dtype.cuh"

namespace t2h {

constexpr int kSpan = 32;  // rows a warp owns (tests/test_torch_pool2_runs.py SPAN)
constexpr unsigned kFull = 0xffffffffu;

// kind: 0 = max, 1 = mean, 2 = sum, 3 = sum split among the tied rows.
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

// The tile check (TILED): whether row lies in the row range of the 256-cell
// tile t = c >> 8 that holds in-range cell c, [to[t * step], to[(t + 1) * step]).
__device__ __forceinline__ bool in_tile(const int* __restrict__ to, int step, int c,
                                        int row) {
  const int t = c >> 8;
  return to[t * step] <= row && row < to[(t + 1) * step];
}

// One 32-row step of a run's walk past its head's span: *len = how many rows
// from j0 on still hold cell c (32: the run goes on); returns their valid bits
// (the mask; TILED: the rows in [lo, hi), the row range of c's tile).
template <bool TILED>
__device__ __forceinline__ unsigned run_step(const int* __restrict__ cb,
                                             const uint8_t* __restrict__ mb, int lo, int hi,
                                             int j0, int N, int c, int lane, int* len) {
  const int j = j0 + lane;
  const unsigned same = __ballot_sync(kFull, j < N && cb[j] == c);
  *len = same == kFull ? kSpan : __ffs(~same) - 1;
  return __ballot_sync(kFull, lane < *len && (TILED ? lo <= j && j < hi : mb[j] != 0));
}

// TIE: the max-pool backward's gate (KIND 2 and 3). TILED: K10's validity,
// the tile offsets toff (B, ncell / 256 + 1) in place of the mask. A warp's
// lanes take 32 features of every row; F > 32 loops over feature chunks.
// Three blocks an SM (<= 80 registers) without the gate; with it, two (its 96
// loads in flight take 128 registers, and spill under 80).
template <typename T, int KIND, bool TIE, bool TILED>
__global__ void __launch_bounds__(kThreads, TIE ? 2 : 3)
pool_runs(const T* __restrict__ x, const int* __restrict__ cells,
          const uint8_t* __restrict__ mask, const int* __restrict__ toff,
          const T* __restrict__ tie_a, const T* __restrict__ tie_b,
          T* __restrict__ out, int B, int N, int F, int ncell) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int spans = (N + kSpan - 1) / kSpan;
  if (warp >= (long long)B * spans) return;  // warp-uniform
  const long long b = warp / spans;
  const int s0 = static_cast<int>(warp - b * spans) * kSpan;
  const long long base = b * N;  // first row of batch entry b
  const int* cb = cells + base;
  const uint8_t* mb = TILED ? nullptr : mask + base;
  const int* to = TILED ? toff + b * ((ncell >> 8) + 1) : nullptr;

  // lane = row of the span; -1 (no cell) past the end; the neighbours' ids by
  // shuffles, lanes 0 and 31 read the rows beside the span
  const int row = s0 + lane;
  const bool in = row < N;
  const int c = in ? cb[row] : -1;
  const bool ok = c >= 0 && c < ncell;
  const bool m = TILED ? ok && in_tile(to, 1, c, row) : in && mb[row] != 0;
  int edge = -1;
  if (lane == 0 && s0 > 0) edge = cb[s0 - 1];
  if (lane == kSpan - 1 && row + 1 < N) edge = cb[row + 1];
  int cprev = __shfl_up_sync(kFull, c, 1);
  int cnext = __shfl_down_sync(kFull, c, 1);
  if (lane == 0) cprev = edge;
  if (lane == kSpan - 1) cnext = edge;
  const unsigned heads = __ballot_sync(kFull, ok && cprev != c);
  const unsigned same_next = __ballot_sync(kFull, ok && cnext == c);
  // a run's last row in the span: the next row holds another cell, or lane 31
  const unsigned ends = __ballot_sync(kFull, ok && (cnext != c || lane == kSpan - 1));
  const unsigned valid = __ballot_sync(kFull, ok && m);
  const unsigned before = heads ? (heads & (0u - heads)) - 1u : kFull;  // below the first head
  const unsigned own = valid & ~before;  // valid rows of runs headed in this span
  const bool cont = (same_next & ~before) >> (kSpan - 1);  // the last run goes on
  const int c_last = __shfl_sync(kFull, c, kSpan - 1);
  int lo = 0, hi = 0;  // TILED: the row range of the last run's tile
  if (TILED && cont) {
    lo = to[c_last >> 8];
    hi = to[(c_last >> 8) + 1];
  }
  // lane k: the valid rows of the run that ends at row k, from its head on
  const unsigned upto = lane == kSpan - 1 ? kFull : (2u << lane) - 1u;
  const unsigned hb = heads & upto;
  const int run_count = __popc(own & upto & ~(hb ? (1u << (31 - __clz(hb))) - 1u : 0u));

  for (int f0 = 0; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    const bool fin = f < F;
    const T* xf = x + base * F + f;
    const T* af = TIE ? tie_a + base * F + f : nullptr;
    const T* bf = TIE ? tie_b + base * F + f : nullptr;
    // every load of the span first (with the gate's, into arrays of their
    // own: compared as they arrive, they came one latency after another)
    float v[kSpan], ta[TIE ? kSpan : 1], tb[TIE ? kSpan : 1];
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const long long i = (long long)(s0 + k) * F;
      const bool load = fin && (own >> k & 1u);
      v[k] = load ? to_f32(xf[i]) : 0.0f;
      if (TIE) {
        ta[k] = load ? to_f32(af[i]) : 0.0f;
        tb[k] = load ? to_f32(bf[i]) : 0.0f;
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

    // the last run past the span, in row order (KIND 3: and its tied rows)
    int tail_rows = 0, tail_count = 0, tail_tied = 0;
    if (cont) {
      for (int len = kSpan; len == kSpan; tail_rows += len) {
        const int j0 = s0 + kSpan + tail_rows;
        const unsigned tv = run_step<TILED>(cb, mb, lo, hi, j0, N, c_last, lane, &len);
#pragma unroll
        for (int k = 0; k < kSpan; ++k) {
          if (!fin || !(tv >> k & 1u)) continue;
          const long long i = (long long)(j0 + k) * F;
          acc = run_combine<KIND>(acc, to_f32(xf[i]));
          if (KIND == 3 && to_f32(af[i]) == to_f32(bf[i])) ++tail_tied;
        }
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
        int ntied = 0;  // KIND 3: this lane's tied rows of the run, from its head to k
        if (KIND == 3) {
          const unsigned upk = k == kSpan - 1 ? kFull : (2u << k) - 1u;
          const unsigned hk = heads & upk;  // 0: an earlier warp's run, written by it
          const unsigned from = hk ? ~((1u << (31 - __clz(hk))) - 1u) : 0u;
          ntied = __popc(tied & own & upk & from);
        }
        if (k == kSpan - 1 && cont) {
          a = acc;
          count += tail_count;
          ntied += tail_tied;
        }
        cur = KIND == 3 ? (ntied > 0 ? a / static_cast<float>(ntied) : 0.0f)
                        : run_finalize<KIND>(a, count);
      }
      v[k] = cur;
    }

    T* of = out + base * F + f;
    if (fin) {
#pragma unroll
      for (int k = 0; k < kSpan; ++k) {
        const long long i = (long long)(s0 + k) * F;
        const bool mine = own >> k & 1u;
        if (s0 + k >= N || (!mine && (valid >> k & 1u))) continue;  // an earlier run's row
        float o = mine ? v[k] : 0.0f;
        if (TIE && !(tied >> k & 1u)) o = 0.0f;
        of[i] = from_f32<T>(o);
      }
    }
    if (cont) {  // the last run's rows past the span
      const T r = from_f32<T>(v[kSpan - 1]);
      for (int done = 0, len = kSpan; len == kSpan; done += len) {
        const int j0 = s0 + kSpan + done;
        const unsigned tv = run_step<TILED>(cb, mb, lo, hi, j0, N, c_last, lane, &len);
#pragma unroll
        for (int k = 0; k < kSpan; ++k) {
          if (!fin || !(tv >> k & 1u)) continue;
          const long long i = (long long)(j0 + k) * F;
          of[i] = TIE && to_f32(af[i]) != to_f32(bf[i]) ? from_f32<T>(0.0f) : r;
        }
      }
    }
  }
}

// K2 alone (scatter_plane2's backward; K12's backward at a coarser level,
// cell = id >> shift, with no mask: every row whose cell is in range): each
// valid row (mask set or no mask, 0 <= cell < reso^2) reads the row-major
// plane (B, reso, reso, F) at its Morton cell,
// divided by max(count, 1); every other row gets 0. pool_runs' partition:
// warp = (batch entry, 32-row span, chunk of 32 features), chunk fastest;
// lane k takes row k's cell id and mask byte (one coalesced load each), its
// row-major cell (morton_to_rowmajor once a row) and that cell's count. A
// valid row loads its plane row only where its cell differs from the
// previous valid row's in the span (a new run, or the span's first valid
// row); the loads of a group of 16 rows go out before the group's stores (32
// at once, with their 32 addresses, spill at 80 registers), each loaded
// value is divided by its cell's count once (the plain version's division,
// so the result is its bits), and the rows then take the latest load in row
// order from a register. So each run inside a span reads its plane row and
// count once, and each row is written once, by one warp, with no atomic:
// bit-equal run to run. Correctness does not depend on the order of the rows
// (unlike scatter_plane2's forward on scatter_runs, which needs the runs
// contract): unsorted rows only load more often. No 64-bit divide: a thread
// splits its warp index once, in 32 bits.
//
// Bound on the H100: bytes: the plane and counts at the occupied cells,
// every row's cell id and mask, the output written once. At B = 8, Npad =
// 20480, F = 32 the output alone is 21 MB (~6.3 us at 3.35 TB/s); all of it
// ~36 MB, ~11 us.
//
// CUT: the count rounded to bf16 before the division, as JAX's K12 backward
// divides by counts.astype(bf16) (fused.py:170): a cell of more than 256 rows
// takes the nearest bf16 count. fused2's K2 (scatter_plane2's backward,
// pool2_kernel.py:424-453) divides by the exact count and takes CUT false.
constexpr int kGatherGroup = 16;  // rows loaded at once

template <typename T, bool CUT>
__global__ void __launch_bounds__(kThreads, 3)
pool_gather(const T* __restrict__ plane, const int* __restrict__ cells,
            const uint8_t* __restrict__ mask, const int* __restrict__ counts,
            T* __restrict__ out, int N, int F, int reso, int shift, unsigned warps,
            unsigned spans, unsigned chunks) {
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= warps) return;  // warp-uniform
  const unsigned fc = warp % chunks;
  const unsigned bs = warp / chunks;
  const unsigned b = bs / spans;
  const int s0 = static_cast<int>(bs - b * spans) * kSpan;
  const long long base = (long long)b * N;  // first row of batch entry b
  const int ncell = reso * reso;

  // lane = row of the span: its row-major cell (-1: not valid) and count
  const int row = s0 + lane;
  int dst = -1;
  float n = 1.0f;
  if (row < N) {
    const int raw = cells[base + row];
    const int c = raw >> shift;
    if ((mask == nullptr || mask[base + row] != 0) && raw >= 0 && c < ncell) {
      dst = morton_to_rowmajor(c, reso);
      const int k = counts[(long long)b * ncell + dst];
      n = static_cast<float>(k > 1 ? k : 1);
      if (CUT) n = round_as<bf16>(n);
    }
  }
  const unsigned valid = __ballot_sync(kFull, dst >= 0);
  const unsigned below = valid & ((1u << lane) - 1u);  // valid rows before this one
  const int dprev = __shfl_sync(kFull, dst, below ? 31 - __clz(below) : lane);
  const unsigned loads = __ballot_sync(kFull, dst >= 0 && (below == 0 || dprev != dst));
  const int rows = min(kSpan, N - s0);

  const int f = fc * 32 + lane;
  const bool fin = f < F;
  const T* pb = plane + (long long)b * ncell * F + f;
  T* ob = out + base * F + f;
  float cur = 0.0f;  // the latest load, divided
#pragma unroll
  for (int g = 0; g < kSpan; g += kGatherGroup) {
    float v[kGatherGroup];
#pragma unroll
    for (int k = 0; k < kGatherGroup; ++k) {
      const int d = __shfl_sync(kFull, dst, g + k);
      v[k] = fin && (loads >> (g + k) & 1u) ? to_f32(pb[(long long)d * F]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kGatherGroup; ++k) {
      const int r = g + k;
      const float nr = __shfl_sync(kFull, n, r);
      if (loads >> r & 1u) cur = v[k] / nr;
      if (fin && r < rows) ob[(long long)(s0 + r) * F] = from_f32<T>(valid >> r & 1u ? cur : 0.0f);
    }
  }
}

// A row's cell at this resolution, or -1 when it is out of range (pads,
// negative ids).
__device__ __forceinline__ int level_cell(int raw, int shift, int ncell) {
  const int c = raw >> shift;
  return raw >= 0 && c < ncell ? c : -1;
}

// The zero part: 0 to every plane cell (and count) whose flag is clear.
// Block `block` of `blocks`; a thread takes kZeroItems items, a grid's width
// apart (each store coalesced), their flags loaded first; an item is a float4
// (vec: F % 4 == 0) or a float; q = items a cell, qshift = log2(q) when q is
// a power of two (no division), else -1. A float4 item is four values of T
// (8 bytes in bf16).
constexpr int kZeroItems = 4;

template <typename T>
__device__ __forceinline__ void zero_empty_cells(T* __restrict__ plane,
                                                 int* __restrict__ counts,
                                                 const uint8_t* __restrict__ flags,
                                                 unsigned block, unsigned blocks, unsigned n,
                                                 unsigned q, int qshift, bool vec) {
  const unsigned stride = blocks * blockDim.x;
  const unsigned i0 = block * blockDim.x + threadIdx.x;
  unsigned cell[kZeroItems];
  bool empty[kZeroItems];
#pragma unroll
  for (int k = 0; k < kZeroItems; ++k) {
    const unsigned i = i0 + k * stride;
    cell[k] = qshift >= 0 ? i >> qshift : i / q;
    empty[k] = i < n && !flags[cell[k]];
  }
#pragma unroll
  for (int k = 0; k < kZeroItems; ++k) {
    if (!empty[k]) continue;
    const unsigned i = i0 + k * stride;
    if (vec) {
      const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      store_vec<4>(plane + 4 * (long long)i, zero);
    } else {
      plane[i] = from_f32<T>(0.0f);
    }
    if (counts != nullptr && i == cell[k] * q) counts[cell[k]] = 0;
  }
}

// The mark pass: flags[cell] = 1 for every cell that holds a valid row; a
// thread a row (blockIdx.y = batch entry). Rows of one cell store the same
// byte, so their order does not matter. The flags are laid out as the
// output (MORTON: cell c at c, else at its row-major index), since the zero
// part walks the two together.
template <bool TILED, bool MORTON>
__global__ void mark_cells(const int* __restrict__ cells, const uint8_t* __restrict__ mask,
                           const int* __restrict__ toff, uint8_t* __restrict__ flags, int N,
                           int reso, int shift, int toff_row, int toff_step) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long b = blockIdx.y;
  const int ncell = reso * reso;
  const int c = level_cell(cells[b * N + row], shift, ncell);
  if (c < 0) return;
  const int* to = TILED ? toff + b * toff_row : nullptr;
  if (TILED ? in_tile(to, toff_step, c, row) : mask[b * N + row] != 0)
    flags[b * ncell + (MORTON ? c : morton_to_rowmajor(c, reso))] = 1;
}

template <int VEC, typename T>
__device__ __forceinline__ void store_mean(T* __restrict__ p, const float (&a)[VEC], int count) {
  const float n = static_cast<float>(count);
  float m[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) m[e] = a[e] / n;
  store_vec<VEC>(p, m);
}

// K3 and K4's plane (TILED false: mask) and K11-K14 (TILED true: tile offsets, no mask;
// K13 MORTON: the output in Morton order): the run part and the zero part in
// one launch, after the mark pass. The run part's
// warp = (batch entry, span, chunk of 32 * VEC features), chunk fastest, so a
// block's warps share the span's ids in L1 when there are 8 chunks or more;
// a lane loads VEC features of a row at once (VEC 4: a row's 128 features
// are one 512-byte load). The span's rows load in groups of 32 / VEC (4 KB a
// warp in flight, 32 registers of values) and are summed as they come, each
// run's end written at once. Three blocks an SM (<= 80 registers).
template <typename T, bool TILED, int VEC, bool MORTON>
__global__ void __launch_bounds__(kThreads, 3)
scatter_runs(const T* __restrict__ x, const int* __restrict__ cells,
             const uint8_t* __restrict__ mask, const int* __restrict__ toff,
             T* __restrict__ plane, int* __restrict__ counts,
             const uint8_t* __restrict__ flags, int B, int N, int F, int reso, int shift,
             int toff_row, int toff_step, unsigned run_blocks, unsigned zero_blocks,
             unsigned zero_n, unsigned zero_q, int zero_qshift) {
  constexpr int kGroup = kSpan / VEC;  // rows loaded at once
  // blocks alternate between the two parts while both have blocks left
  const unsigned pairs = min(run_blocks, zero_blocks);
  const bool zero_part = blockIdx.x < 2 * pairs ? blockIdx.x & 1u : run_blocks < zero_blocks;
  const unsigned part_block = blockIdx.x < 2 * pairs ? blockIdx.x >> 1 : blockIdx.x - pairs;
  if (zero_part) {
    zero_empty_cells(plane, counts, flags, part_block, zero_blocks, zero_n, zero_q,
                     zero_qshift, F % 4 == 0);
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)part_block * blockDim.x + threadIdx.x) >> 5;
  const int chunks = (F + 32 * VEC - 1) / (32 * VEC);
  const int spans = (N + kSpan - 1) / kSpan;
  if (warp >= (long long)B * spans * chunks) return;  // warp-uniform
  const int fc = static_cast<int>(warp % chunks);
  const long long bs = warp / chunks;
  const long long b = bs / spans;
  const int s0 = static_cast<int>(bs - b * spans) * kSpan;
  const long long base = b * N;  // first row of batch entry b
  const int* cb = cells + base;
  const uint8_t* mb = TILED ? nullptr : mask + base;
  const int* to = TILED ? toff + b * toff_row : nullptr;
  const int ncell = reso * reso;

  // lane = row of the span: its cell, -1 out of range; the neighbours' by
  // shuffles, lanes 0 and 31 read the rows beside the span
  const int row = s0 + lane;
  const bool in = row < N;
  const int c = in ? level_cell(cb[row], shift, ncell) : -1;
  const bool mk = !TILED && in && mb[row] != 0;
  int edge = -1;
  if (lane == 0 && s0 > 0) edge = level_cell(cb[s0 - 1], shift, ncell);
  if (lane == kSpan - 1 && row + 1 < N) edge = level_cell(cb[row + 1], shift, ncell);
  int cprev = __shfl_up_sync(kFull, c, 1);
  int cnext = __shfl_down_sync(kFull, c, 1);
  if (lane == 0) cprev = edge;
  if (lane == kSpan - 1) cnext = edge;
  const bool ok = c >= 0;
  const unsigned heads = __ballot_sync(kFull, ok && cprev != c);
  if (heads == 0) return;  // warp-uniform: every run here is an earlier warp's
  bool m = mk;
  if (TILED) m = ok && in_tile(to, toff_step, c, row);
  const unsigned before = (heads & (0u - heads)) - 1u;  // below the first head
  const unsigned own = __ballot_sync(kFull, m) & ~before;  // valid rows of own runs
  const bool cont = (__ballot_sync(kFull, ok && cnext == c) & ~before) >> (kSpan - 1);
  // a run's last row in the span (the next row holds another cell); the
  // last run, if it goes on, is written after the walk past the span
  const unsigned ends =
      __ballot_sync(kFull, ok && (cnext != c || lane == kSpan - 1)) & ~before &
      ~(cont ? 1u << (kSpan - 1) : 0u);
  // lane k: the valid rows of the run that ends at row k, from its head on
  const unsigned upto = lane == kSpan - 1 ? kFull : (2u << lane) - 1u;
  const unsigned hb = heads & upto;
  const int run_count = __popc(own & upto & ~(hb ? (1u << (31 - __clz(hb))) - 1u : 0u));

  const int f = (fc * 32 + lane) * VEC;
  const bool fin = f < F;  // F % VEC == 0: a lane's VEC features all in range
  const T* xf = x + base * F + f;
  T* pb = plane + b * ncell * F + f;
  // lane k: row k's cell in the output (the index the mark pass flagged)
  const int my_dst = ok ? (MORTON ? c : morton_to_rowmajor(c, reso)) : 0;
  auto write = [&](int k, const float (&a)[VEC], int count) {
    const int dst = __shfl_sync(kFull, my_dst, k);
    if (fin) store_mean<VEC>(pb + (long long)dst * F, a, count);
    if (counts != nullptr && fc == 0 && lane == 0) counts[b * ncell + dst] = count;
  };

  // the span's own runs in row order, a group of rows at a time
  float acc[VEC] = {};
#pragma unroll
  for (int g = 0; g < kSpan; g += kGroup) {
    float v[kGroup][VEC];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (fin && (own >> (g + k) & 1u)) {
        load_vec<VEC>(xf + (long long)(s0 + g + k) * F, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int r = g + k;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (heads >> r & 1u) acc[e] = 0.0f;
        if (own >> r & 1u) acc[e] += v[k][e];
      }
      if (ends >> r & 1u) {
        const int count = __shfl_sync(kFull, run_count, r);
        if (count > 0) write(r, acc, count);
      }
    }
  }

  // the last run past the span, in row order, 32 rows a step; the next
  // step's ids (and mask) load while this step's rows do
  if (cont) {
    int count = __shfl_sync(kFull, run_count, kSpan - 1);
    int lo = 0, hi = 0;
    const int c_last = __shfl_sync(kFull, c, kSpan - 1);
    if (TILED) {
      lo = to[(c_last >> 8) * toff_step];
      hi = to[((c_last >> 8) + 1) * toff_step];
    }
    int j0 = s0 + kSpan;
    int cn = j0 + lane < N ? cb[j0 + lane] : -1;
    bool mn = !TILED && j0 + lane < N && mb[j0 + lane] != 0;
    for (;;) {
      const int j = j0 + lane;
      const unsigned same = __ballot_sync(kFull, level_cell(cn, shift, ncell) == c_last);
      const int len = same == kFull ? kSpan : __ffs(~same) - 1;
      const unsigned tv =
          __ballot_sync(kFull, lane < len && (TILED ? lo <= j && j < hi : mn));
      if (len == kSpan) {
        cn = j + kSpan < N ? cb[j + kSpan] : -1;
        if (!TILED) mn = j + kSpan < N && mb[j + kSpan] != 0;
      }
#pragma unroll
      for (int g = 0; g < kSpan; g += kGroup) {
        float v[kGroup][VEC];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (fin && (tv >> (g + k) & 1u)) {
            load_vec<VEC>(xf + (long long)(j0 + g + k) * F, v[k]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (tv >> (g + k) & 1u) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += v[k][e];
          }
      }
      count += __popc(tv);
      if (len < kSpan) break;
      j0 += kSpan;
    }
    if (count > 0) write(kSpan - 1, acc, count);
  }
}

// The entry points' launches, for either element type (below).
template <typename T>
int launch_pool_runs(const T* x, const int* cells, const uint8_t* mask, const int* toff,
                     const T* tie_a, const T* tie_b, T* out, int B, int N, int F, int ncell,
                     int kind, cudaStream_t stream) {
  const bool tie = tie_a != nullptr;
  const bool tiled = toff != nullptr;
  if (kind < 0 || kind > 3 || tie != (tie_b != nullptr) || (tie && kind < 2) ||
      (kind == 3 && !(tie && tiled)) || tiled == (mask != nullptr) ||
      (tiled && (kind == 2 || ncell % 256 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (long long)B * ((N + kSpan - 1) / kSpan) * 32;
  if (threads == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
#define T2H_RUNS(K, TI, TL)                                                          \
  pool_runs<T, K, TI, TL><<<blocks, kThreads, 0, stream>>>(x, cells, mask, toff, tie_a, \
                                                           tie_b, out, B, N, F, ncell)
  if (tiled && kind == 3) T2H_RUNS(3, true, true);
  else if (tiled && kind == 0) T2H_RUNS(0, false, true);
  else if (tiled) T2H_RUNS(1, false, true);
  else if (tie) T2H_RUNS(2, true, false);
  else if (kind == 0) T2H_RUNS(0, false, false);
  else if (kind == 1) T2H_RUNS(1, false, false);
  else T2H_RUNS(2, false, false);
#undef T2H_RUNS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CUT>
int launch_pool_gather(const T* plane, const int* cells, const uint8_t* mask,
                       const int* counts, T* out, int B, int N, int F, int reso, int shift,
                       cudaStream_t stream) {
  const long long spans = (N + kSpan - 1) / kSpan;
  const long long chunks = (F + 31) / 32;
  const long long warps = (long long)B * spans * chunks;
  if (warps * 32 >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > 0)
    pool_gather<T, CUT>
        <<<static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>(plane, cells, mask, counts, out, N, F, reso, shift,
                     static_cast<unsigned>(warps), static_cast<unsigned>(spans),
                     static_cast<unsigned>(chunks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter_runs(const T* values, const int* cells, const uint8_t* mask,
                        const int* toff, T* plane, int* counts, uint8_t* flags, int B, int N,
                        int F, int reso, int shift, int toff_row, int toff_step, int morton,
                        cudaStream_t stream) {
  const bool tiled = toff != nullptr;
  const long long ncells = (long long)B * reso * reso;
  const bool vec = F % 4 == 0;
  const long long items = ncells * (vec ? F / 4 : F);
  if (tiled == (mask != nullptr) || (!tiled && counts == nullptr) || items >= (1LL << 31) ||
      (morton && (!tiled || counts != nullptr)) ||
      (tiled && ((reso * reso) % 256 != 0 || toff_step < 1 ||
                 toff_row < (reso * reso / 256) * toff_step + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(flags, 0, ncells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0) {
    const dim3 grid((N + kThreads - 1) / kThreads, B);
#define T2H_MARK(TI, M)                                                                   \
  mark_cells<TI, M><<<grid, kThreads, 0, stream>>>(cells, mask, toff, flags, N, reso, shift, \
                                                   toff_row, toff_step)
    if (morton) T2H_MARK(true, true);
    else if (tiled) T2H_MARK(true, false);
    else T2H_MARK(false, false);
#undef T2H_MARK
  }
  // a lane takes VEC features: 4 from F = 128 on, 2 from 64 (1 for values
  // not aligned to 16 bytes)
  const bool aligned = reinterpret_cast<uintptr_t>(values) % 16 == 0;
  const int run_vec = !aligned ? 1 : F % 4 == 0 && F >= 128 ? 4 : F % 2 == 0 && F >= 64 ? 2 : 1;
  const long long threads =
      (long long)B * ((N + kSpan - 1) / kSpan) * ((F + 32 * run_vec - 1) / (32 * run_vec)) * 32;
  const unsigned run_blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const unsigned q = vec ? F / 4 : F;
  const int qshift = (q & (q - 1)) == 0 ? __builtin_ctz(q) : -1;
  const unsigned zero_blocks =
      static_cast<unsigned>((items + kThreads * kZeroItems - 1) / (kThreads * kZeroItems));
#define T2H_SCATTER_RUNS(TI, V, M)                                                        \
  scatter_runs<T, TI, V, M><<<run_blocks + zero_blocks, kThreads, 0, stream>>>(           \
      values, cells, mask, toff, plane, counts, flags, B, N, F, reso, shift, toff_row,    \
      toff_step, run_blocks, zero_blocks, static_cast<unsigned>(items), q, qshift)
  if (morton) {
    if (run_vec == 4) T2H_SCATTER_RUNS(true, 4, true);
    else if (run_vec == 2) T2H_SCATTER_RUNS(true, 2, true);
    else T2H_SCATTER_RUNS(true, 1, true);
  } else if (tiled) {
    if (run_vec == 4) T2H_SCATTER_RUNS(true, 4, false);
    else if (run_vec == 2) T2H_SCATTER_RUNS(true, 2, false);
    else T2H_SCATTER_RUNS(true, 1, false);
  } else {
    if (run_vec == 4) T2H_SCATTER_RUNS(false, 4, false);
    else if (run_vec == 2) T2H_SCATTER_RUNS(false, 2, false);
    else T2H_SCATTER_RUNS(false, 1, false);
  }
#undef T2H_SCATTER_RUNS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t2h

using namespace t2h;

extern "C" {

const char* t2h_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,N,F) f32, cells (B,N) i32 Morton ids (each cell's rows contiguous),
// and either mask (B,N) u8 (K1 + K2, toff null; kind 0-2) or toff
// (B,ncell/256+1) i32 row offsets of the 256-cell tiles (K10, mask null;
// ncell a multiple of 256; kind 0 or 1, or 3 with the tie) -> out (B,N,F):
// each valid row gets its run's max (kind 0), mean (1), sum (2) or sum split
// among its tied rows (3), the other rows 0. tie_a/tie_b (B,N,F) or both
// null: with them (kind 2 or 3) a row keeps its value only where tie_a ==
// tie_b; kind 3 needs them. One launch.
int t2h_pool_runs(const float* x, const int* cells, const uint8_t* mask, const int* toff,
                  const float* tie_a, const float* tie_b, float* out, int B, int N, int F,
                  int ncell, int kind, cudaStream_t stream) {
  return launch_pool_runs(x, cells, mask, toff, tie_a, tie_b, out, B, N, F, ncell, kind,
                          stream);
}

// The same on bf16 x, tie_a, tie_b and out (K1 + K2 in the model's bf16
// dtype, JAX pool2_kernel.py:88-117,148-158,492-517): the values summed
// (or maxed) in f32 in the same run order, each output rounded to bf16 once,
// the tie gate compared in f32.
int t2h_pool_runs_bf16(const bf16* x, const int* cells, const uint8_t* mask, const int* toff,
                       const bf16* tie_a, const bf16* tie_b, bf16* out, int B, int N, int F,
                       int ncell, int kind, cudaStream_t stream) {
  return launch_pool_runs(x, cells, mask, toff, tie_a, tie_b, out, B, N, F, ncell, kind,
                          stream);
}

// plane (B,reso,reso,F) row-major, cells (B,N) Morton ids (the cell at reso
// is cells >> shift), mask (B,N) or null (every row whose cell is in range),
// counts (B,reso,reso) -> out (B,N,F) = plane[cell] / max(count,1) on the
// valid rows, 0 on the others. One launch; any row order.
int t2h_pool_gather(const float* plane, const int* cells, const uint8_t* mask,
                    const int* counts, float* out, int B, int N, int F, int reso, int shift,
                    cudaStream_t stream) {
  return launch_pool_gather<float, false>(plane, cells, mask, counts, out, B, N, F, reso,
                                          shift, stream);
}

// The same on a bf16 plane and out: the f32 quotient rounded to bf16 once
// (JAX pool2_kernel.py:424-453 rounds (g / count) to the dtype, then gathers).
int t2h_pool_gather_bf16(const bf16* plane, const int* cells, const uint8_t* mask,
                         const int* counts, bf16* out, int B, int N, int F, int reso,
                         int shift, cudaStream_t stream) {
  return launch_pool_gather<bf16, false>(plane, cells, mask, counts, out, B, N, F, reso,
                                         shift, stream);
}

// The same with each count rounded to bf16 before the division: K12's
// backward in bf16 (JAX fused.py:149-173 divides the bf16 cotangent by
// counts.astype(bf16)), the quotient rounded to bf16 once.
int t2h_pool_gather_cut_bf16(const bf16* plane, const int* cells, const uint8_t* mask,
                             const int* counts, bf16* out, int B, int N, int F, int reso,
                             int shift, cudaStream_t stream) {
  return launch_pool_gather<bf16, true>(plane, cells, mask, counts, out, B, N, F, reso,
                                        shift, stream);
}

// values (B,N,F) f32, cells (B,N) i32 Morton ids (finest; the cell at reso
// is cells >> shift), flags (B,reso,reso) u8 scratch -> plane (B,reso,reso,F)
// row-major scatter-mean of the valid rows, 0 on empty cells; morton != 0:
// the Morton-ordered cell vector (B,reso*reso,F) instead, the flags in the
// same order (tiled only). Either K3: mask (B,N) u8, toff null, counts
// (B,reso,reso) i32 written (K4's plane the same, at its level's shift); or
// K11-K14: mask null, toff (B,toff_row) i32, tile t of the reso^2/256 tiles
// spanning rows [toff[t * toff_step], toff[(t + 1) * toff_step]) (K12: tile
// offsets, step 1; K11, K13: per-cell offsets, step 256; K14: finest tile
// offsets, step 4^level; reso^2 a multiple of 256), counts null or, not in
// Morton order, written as K3's (K12 in training, for its backward). Three
// launches: clear, mark, runs + zeros.
int t2h_scatter_runs(const float* values, const int* cells, const uint8_t* mask,
                     const int* toff, float* plane, int* counts, uint8_t* flags, int B,
                     int N, int F, int reso, int shift, int toff_row, int toff_step,
                     int morton, cudaStream_t stream) {
  return launch_scatter_runs(values, cells, mask, toff, plane, counts, flags, B, N, F, reso,
                             shift, toff_row, toff_step, morton, stream);
}

// The same on bf16 values and plane (K3 and K4's plane in the model's bf16
// dtype, JAX pool2_kernel.py:292-334, level_kernel.py:281-310): each run's
// row-order sum in f32, its mean rounded to bf16 once.
int t2h_scatter_runs_bf16(const bf16* values, const int* cells, const uint8_t* mask,
                          const int* toff, bf16* plane, int* counts, uint8_t* flags, int B,
                          int N, int F, int reso, int shift, int toff_row, int toff_step,
                          int morton, cudaStream_t stream) {
  return launch_scatter_runs(values, cells, mask, toff, plane, counts, flags, B, N, F, reso,
                             shift, toff_row, toff_step, morton, stream);
}

}  // extern "C"
