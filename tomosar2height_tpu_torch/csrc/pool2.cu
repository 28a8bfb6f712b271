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
// row, all storing 1); then one launch of the run part (the occupied cells)
// and the zero part (0 to every cell, and count, whose flag is clear), so
// the latency-bound walk of the runs and the bandwidth-bound zeros overlap,
// and no warp walks a gap of empty cells. Where the level has more cells
// than rows (256^2: the zeros are most of the plane, >= 75% of the cells)
// the two parts' blocks alternate; else the run part's blocks come first
// and the zero part's fill their tail (an SM's three blocks are shared, and
// alternating blocks halve the run part's warps while the zeros last). Each
// plane cell and each count is written once; no float atomic; bit-equal run
// to run. Cell ids
// cannot be binary-searched (pads carry the sentinel mid-entry), so every
// row's id is read. The run part's grid is sized by spans x feature chunks,
// not by tiles, so a level of few tiles (32^2, 16^2) gets as many warps as
// 256^2; a lane takes 1, 2 or 4 features (F < 64, < 128, from 128 on), in
// bf16 8 (16 bytes) from F = 256 on. Its time is the latency of a few
// dependent loads a span (ids, tile offsets, values), not bytes
// (tools/time_scatter.py --parts), so a bf16 lane keeps its loads' raw
// words, two values a register: twice the rows in flight that f32 keeps at
// one width. The zero part stores 16 bytes an item.
//
// Bound on the H100: bytes: values on the valid rows, every row's cell id (and
// mask, K3; tile offsets, K11-K13), the plane and counts written once (+ the
// flags). K3 at B = 8, Npad = 20480, F = 32: ~16 MB of values and ~67 MB of
// plane, ~26 us at 3.35 TB/s; the zeros are most of it.
//
// bf16 (the model's bf16 dtype): pool_runs, pool_gather and scatter_runs
// are templated on the value type T (dtype.cuh). A bf16 instance reads bf16
// values (scatter_runs: 2, 4, 8 or 16 bytes a lane; pool_runs_staged and
// pool_gather_items, the routes of pool_runs and pool_gather for aligned
// tensors whose F is a multiple of 16 bytes' values: 16 bytes a lane), sums or
// maxes them in f32 in the same row order as the f32 instance, and rounds each
// output to bf16 once, where it stores it: the JAX kernels' bf16 rule
// (pool2_kernel.py:88-117 f32 accumulators cast to the dtype, :148-158 the
// gather in the dtype, :292-334 the plane mean in f32 written in the dtype,
// :424-453 (g / count) rounded then gathered, :514 the tie gate in f32).
// Counts stay int32; the bytes of the values and outputs halve. With a lane
// a feature, a bf16 warp instruction moves 64 bytes, and the lane-a-feature
// kernels took longer in bf16 than in f32 (instructions and latency, not
// bytes): hence the 16-byte routes, each bit-equal to the kernel it
// replaces on its shapes, which stays the route for the others.

#include "dtype.cuh"

namespace t2h {

constexpr int kSpan = 32;  // rows a warp owns (tests/test_torch_pool2_runs.py SPAN)

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

// A warp's span in a launch of pool_runs or pool_runs_staged, and the span's
// runs as the warp finds them: lane = row of the span, -1 (no cell) past the
// end; the neighbours' ids by shuffles, lanes 0 and 31 read the rows beside
// the span. false where the warp has no span (warp-uniform).
struct Span {
  long long base;                    // first row of the batch entry
  int s0;                            // the span's first row
  const int* cb;                     // the entry's cell ids
  const uint8_t* mb;                 // and its mask (not TILED)
  unsigned heads, ends, valid, own;  // bits by row of the span
  bool cont;                         // the last run goes on past the span
  int c_last, lo, hi;                // its cell; TILED: the row range of its tile
  int run_count;  // lane k: the valid rows of the run that ends at row k, from its head on
};

template <bool TILED>
__device__ __forceinline__ bool find_span(const int* __restrict__ cells,
                                          const uint8_t* __restrict__ mask,
                                          const int* __restrict__ toff, int B, int N,
                                          int ncell, int lane, Span& sp);  // below pool_runs

// A run's result from its accumulator, its valid rows and (KIND 3) its tied
// rows.
template <int KIND>
__device__ __forceinline__ float run_result(float acc, int count, int ntied) {
  return KIND == 3 ? (ntied > 0 ? acc / static_cast<float>(ntied) : 0.0f)
                   : run_finalize<KIND>(acc, count);
}

// The last run's walk past its head's span (sp.cont), 32 rows a step, lane =
// feature (xf, af, bf: x, tie_a, tie_b at this lane's feature of the entry's
// first row): folds each valid row into acc in row order (KIND 3: counts the
// tied ones into *tied) and returns the rows' count. U: the inner loop's
// unroll (pool_runs unrolls it fully; pool_runs_staged by 4, where a full
// unroll spilled).
template <typename T, int KIND, bool TILED, int U>
__device__ __forceinline__ int walk_tail(const Span& sp, const T* __restrict__ xf,
                                         const T* __restrict__ af, const T* __restrict__ bf,
                                         int N, int F, bool fin, int lane, float* acc,
                                         int* tied) {
  int count = 0;
  for (int rows = 0, len = kSpan; len == kSpan; rows += len) {
    const int j0 = sp.s0 + kSpan + rows;
    const unsigned tv = run_step<TILED>(sp.cb, sp.mb, sp.lo, sp.hi, j0, N, sp.c_last, lane, &len);
#pragma unroll (U)
    for (int k = 0; k < kSpan; ++k) {
      if (!fin || !(tv >> k & 1u)) continue;
      const long long i = (long long)(j0 + k) * F;
      *acc = run_combine<KIND>(*acc, to_f32(xf[i]));
      if (KIND == 3 && to_f32(af[i]) == to_f32(bf[i])) ++*tied;
    }
    count += __popc(tv);
  }
  return count;
}

// The same walk writing the run's result r to each of its valid rows past the
// span (of: out at this lane's feature of the entry's first row; TIE: 0 where
// the row does not tie).
template <typename T, bool TIE, bool TILED, int U>
__device__ __forceinline__ void fill_tail(const Span& sp, T* __restrict__ of,
                                          const T* __restrict__ af, const T* __restrict__ bf,
                                          T r, int N, int F, bool fin, int lane) {
  for (int done = 0, len = kSpan; len == kSpan; done += len) {
    const int j0 = sp.s0 + kSpan + done;
    const unsigned tv = run_step<TILED>(sp.cb, sp.mb, sp.lo, sp.hi, j0, N, sp.c_last, lane, &len);
#pragma unroll (U)
    for (int k = 0; k < kSpan; ++k) {
      if (!fin || !(tv >> k & 1u)) continue;
      const long long i = (long long)(j0 + k) * F;
      of[i] = TIE && to_f32(af[i]) != to_f32(bf[i]) ? from_f32<T>(0.0f) : r;
    }
  }
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
  Span sp;
  if (!find_span<TILED>(cells, mask, toff, B, N, ncell, lane, sp)) return;  // warp-uniform
  const long long base = sp.base;
  const int s0 = sp.s0;
  const unsigned heads = sp.heads, ends = sp.ends, valid = sp.valid, own = sp.own;
  const bool cont = sp.cont;
  const int run_count = sp.run_count;

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
    int tail_count = 0, tail_tied = 0;
    if (cont)
      tail_count = walk_tail<T, KIND, TILED, kSpan>(sp, xf, af, bf, N, F, fin, lane, &acc,
                                                    &tail_tied);

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
        cur = run_result<KIND>(a, count, ntied);
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
    if (cont)  // the last run's rows past the span
      fill_tail<T, TIE, TILED, kSpan>(sp, of, af, bf, from_f32<T>(v[kSpan - 1]), N, F, fin,
                                      lane);
  }
}

template <bool TILED>
__device__ __forceinline__ bool find_span(const int* __restrict__ cells,
                                          const uint8_t* __restrict__ mask,
                                          const int* __restrict__ toff, int B, int N,
                                          int ncell, int lane, Span& sp) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int spans = (N + kSpan - 1) / kSpan;
  if (warp >= (long long)B * spans) return false;
  const long long b = warp / spans;
  const int s0 = static_cast<int>(warp - b * spans) * kSpan;
  const long long base = b * N;
  const int* cb = cells + base;
  const uint8_t* mb = TILED ? nullptr : mask + base;
  const int* to = TILED ? toff + b * ((ncell >> 8) + 1) : nullptr;
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
  const bool cont = (same_next & ~before) >> (kSpan - 1);
  const int c_last = __shfl_sync(kFull, c, kSpan - 1);
  int lo = 0, hi = 0;
  if (TILED && cont) {
    lo = to[c_last >> 8];
    hi = to[(c_last >> 8) + 1];
  }
  const unsigned upto = lane == kSpan - 1 ? kFull : (2u << lane) - 1u;
  const unsigned hb = heads & upto;
  const int run_count = __popc(own & upto & ~(hb ? (1u << (31 - __clz(hb))) - 1u : 0u));
  sp = Span{base, s0, cb, mb, heads, ends, valid, own, cont, c_last, lo, hi, run_count};
  return true;
}

// pool_runs with the span staged in shared memory (the route for values,
// outputs and tie values 16-byte aligned with F a multiple of 16 / sizeof(T):
// pool_runs_plan). The partition, the row order of each sum and each run's
// finalisation are pool_runs', so the two give the same bits; only where the
// values wait differs. A warp owns a span as there, and takes its features
// 32 at a time (a step): its lanes copy the step's 32-feature slice of each
// own row into a tile of its own in shared memory, 16 bytes a copy with
// cp.async (8 rows a warp instruction at F = 32 in bf16; under the gate
// tie_a's and tie_b's slices into two more tiles), so no value waits in a
// register. Lane f then scans the tile's column f in row order (each run's
// result written into its last row's slot, whose value it has read), fills
// every row of the span from the results in a backward pass (0 on the rows
// that are not own, and under the gate on the rows that do not tie), and
// the lanes store the rows this warp writes, 16 bytes a lane, from the tile.
// The last run's rows, where it goes on past the span, wait for its walk
// past the span, which loads its rows as pool_runs does (a lane a feature;
// on the flagship's layouts few runs reach it). No value array lives in
// registers: with the gate the bf16 instance keeps four blocks an SM (48 KB
// of tiles a block), where pool_runs keeps two (its 96 values in flight a
// lane); the f32 one two (96 KB a block).
template <typename T, int KIND, bool TIE, bool TILED>
__global__ void __launch_bounds__(kThreads, 4)
pool_runs_staged(const T* __restrict__ x, const int* __restrict__ cells,
                 const uint8_t* __restrict__ mask, const int* __restrict__ toff,
                 const T* __restrict__ tie_a, const T* __restrict__ tie_b,
                 T* __restrict__ out, int B, int N, int F, int ncell) {
  constexpr int kChunk = 32;               // features a step (lane = feature in the scans)
  constexpr int kVec = 16 / sizeof(T);     // values a 16-byte copy
  constexpr int kPieces = kChunk / kVec;   // copies a row of a step
  constexpr int kTile = kSpan * kChunk;    // values a tile
  extern __shared__ __align__(16) unsigned char pool_staged_smem[];
  T* tile = reinterpret_cast<T*>(pool_staged_smem) + (threadIdx.x >> 5) * (TIE ? 3 : 1) * kTile;
  T* tile_a = tile + kTile;  // TIE: tie_a's and tie_b's slices
  T* tile_b = tile_a + kTile;
  const int lane = threadIdx.x & 31;
  Span sp;
  if (!find_span<TILED>(cells, mask, toff, B, N, ncell, lane, sp)) return;  // warp-uniform
  const long long base = sp.base;
  const int s0 = sp.s0;
  const unsigned heads = sp.heads, ends = sp.ends, valid = sp.valid, own = sp.own;
  const bool cont = sp.cont;
  const int run_count = sp.run_count;
  // where the last run goes on: its own rows wait for its walk (heads is not
  // 0 then), and its end is not one of the span's
  const unsigned deferred = cont ? own & ~((1u << (31 - __clz(heads))) - 1u) : 0u;
  const unsigned ends_here = ends & ~(cont ? 1u << (kSpan - 1) : 0u);
  // the rows this warp stores from the tile: every row of the span but the
  // valid rows of an earlier warp's run and the deferred ones
  const int rows = min(kSpan, N - s0);
  const unsigned stores =
      (rows == kSpan ? kFull : (1u << rows) - 1u) & ~(valid & ~own) & ~deferred;

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int pieces = min(kChunk, F - f0) / kVec;  // F % kVec == 0
    const long long row0 = (base + s0) * F + f0;     // the span's first value of the step
    // the own rows' slices into the tiles, 16 bytes a copy
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {  // copy p = 32 j + lane: row p / kPieces
      const int p = 32 * j + lane;
      const int k = p / kPieces;
      const int q = p - k * kPieces;
      if (q < pieces && (own >> k & 1u)) {
        const long long i = row0 + k * F + q * kVec;
        const int o = k * kChunk + q * kVec;
        cp_async16(tile + o, x + i, 16);
        if (TIE) {
          cp_async16(tile_a + o, tie_a + i, 16);
          cp_async16(tile_b + o, tie_b + i, 16);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // segmented scan of column `lane` in row order; a run's result into its
    // last row's slot
    const bool fin = f0 + lane < F;
    float acc = run_identity<KIND>();
    int ntied = 0;      // KIND 3: the run's own rows so far that tie
    unsigned tied = 0;  // TIE: bit k where tie_a == tie_b on own row s0 + k
#pragma unroll 4
    for (int k = 0; k < kSpan; ++k) {
      const int o = k * kChunk + lane;
      if (heads >> k & 1u) {
        acc = run_identity<KIND>();
        ntied = 0;
      }
      if (fin && (own >> k & 1u)) {
        acc = run_combine<KIND>(acc, to_f32(tile[o]));
        if (TIE && to_f32(tile_a[o]) == to_f32(tile_b[o])) {
          tied |= 1u << k;
          ++ntied;
        }
      }
      if (ends_here >> k & 1u) {
        const int count = __shfl_sync(kFull, run_count, k);
        if (fin) tile[o] = from_f32<T>(run_result<KIND>(acc, count, ntied));
      }
    }
    // backward fill: every row of a run gets the run's result
    if (fin) {
      float cur = 0.0f;
#pragma unroll 4
      for (int k = kSpan - 1; k >= 0; --k) {
        const int o = k * kChunk + lane;
        if (ends_here >> k & 1u) cur = to_f32(tile[o]);
        float v = own >> k & 1u ? cur : 0.0f;
        if (TIE && !(tied >> k & 1u)) v = 0.0f;
        tile[o] = from_f32<T>(v);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {  // copy p = 32 j + lane: row p / kPieces
      const int p = 32 * j + lane;
      const int k = p / kPieces;
      const int q = p - k * kPieces;
      if (q < pieces && (stores >> k & 1u))
        *reinterpret_cast<uint4*>(out + row0 + k * F + q * kVec) =
            *reinterpret_cast<const uint4*>(tile + k * kChunk + q * kVec);
    }
    __syncwarp();  // the next step's copies reuse the tiles

    if (cont) {  // the last run past the span, in row order, as pool_runs walks it
      const int f = f0 + lane;
      const T* xf = x + base * F + f;
      const T* af = TIE ? tie_a + base * F + f : nullptr;
      const T* bf = TIE ? tie_b + base * F + f : nullptr;
      int tail_tied = 0;
      const int tail_count =
          walk_tail<T, KIND, TILED, 4>(sp, xf, af, bf, N, F, fin, lane, &acc, &tail_tied);
      const int count = __shfl_sync(kFull, run_count, kSpan - 1) + tail_count;
      const T r = from_f32<T>(run_result<KIND>(acc, count, ntied + tail_tied));
      T* of = out + base * F + f;
      if (fin) {  // its rows in the span
        for (unsigned d = deferred; d != 0; d &= d - 1u) {
          const int k = __ffs(d) - 1;
          of[(long long)(s0 + k) * F] = TIE && !(tied >> k & 1u) ? from_f32<T>(0.0f) : r;
        }
      }
      fill_tail<T, TIE, TILED, 4>(sp, of, af, bf, r, N, F, fin, lane);  // and past it
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
// Row `row` of batch entry b (its first row at base) in K2: its row-major
// cell at reso (cells >> shift), -1 where the row is not valid (past N,
// masked, out of range), and in *n that cell's count as a float, at least 1
// (CUT: rounded to bf16).
template <bool CUT>
__device__ __forceinline__ int gather_row(const int* __restrict__ cells,
                                          const uint8_t* __restrict__ mask,
                                          const int* __restrict__ counts, long long base,
                                          unsigned b, int row, int N, int reso, int shift,
                                          float* n) {
  *n = 1.0f;
  if (row >= N) return -1;
  const int ncell = reso * reso;
  const int raw = cells[base + row];
  const int c = raw >> shift;
  if ((mask != nullptr && mask[base + row] == 0) || raw < 0 || c >= ncell) return -1;
  const int dst = morton_to_rowmajor(c, reso);
  const int k = counts[(long long)b * ncell + dst];
  *n = static_cast<float>(k > 1 ? k : 1);
  if (CUT) *n = round_as<bf16>(*n);
  return dst;
}

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
  float n;
  const int dst = gather_row<CUT>(cells, mask, counts, base, b, s0 + lane, N, reso, shift, &n);
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

// K2 alone on (row, 16-byte chunk) items: the route where F is a multiple of
// 16 / sizeof(T) and the plane and output are 16-byte aligned
// (pool_gather_plan; pool_gather is the other). A warp owns a 32-row span and
// every feature of it: lane r takes row r's cell, mask byte and count once,
// as pool_gather. An item is a row's 16-byte chunk (VEC values): it loads
// the plane's chunk at the row's cell, divides each value in f32 by the
// row's count (cut to bf16 under CUT) and stores 16 bytes, so a warp
// instruction covers 32 / lpr rows (8 at F = 32 in bf16, a whole row of 512
// bytes from F = 256 on). The span's rows split into segs segments of
// seg_rows consecutive rows, one a group of lpr lanes (lpr = chunks a row,
// at most 32; past 32 the warp walks the chunk groups in turn), and each
// lane walks its segment in row order: it loads only where a row is valid
// and the first valid row of the segment or its cell differs from the
// previous valid row's, divides there, and the rows then take that quotient
// from a register (kGatherBatch rows' loads in flight at once). So each
// run's plane chunk is read and divided once a segment (a span from F = 256
// on, where the coarse levels' cells hold tens of rows), each value is the
// plain version's quotient (bit-equal to pool_gather), and each output
// element is written once, by one warp.
constexpr int kGatherBatch = 4;  // rows of a segment whose loads go out at once

template <typename T, bool CUT, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
pool_gather_items(const T* __restrict__ plane, const int* __restrict__ cells,
                  const uint8_t* __restrict__ mask, const int* __restrict__ counts,
                  T* __restrict__ out, int N, int F, int reso, int shift, unsigned warps,
                  unsigned spans, int lpr, int segs, int seg_rows, int chunks) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= warps) return;  // warp-uniform
  const unsigned b = warp / spans;
  const int s0 = static_cast<int>(warp - b * spans) * kSpan;
  const long long base = (long long)b * N;  // first row of batch entry b
  const int ncell = reso * reso;

  // lane = row of the span: its row-major cell (-1: not valid) and count
  float n;
  const int dst = gather_row<CUT>(cells, mask, counts, base, b, s0 + lane, N, reso, shift, &n);
  const unsigned valid = __ballot_sync(kFull, dst >= 0);
  const unsigned below = valid & ((1u << lane) - 1u);  // valid rows before this one
  const int dprev = __shfl_sync(kFull, dst, below ? 31 - __clz(below) : lane);
  // the valid rows before this one in its segment
  const unsigned seg_below = below & ~((1u << (lane / seg_rows * seg_rows)) - 1u);
  const unsigned loads = __ballot_sync(kFull, dst >= 0 && (seg_below == 0 || dprev != dst));
  const int rows = min(kSpan, N - s0);

  // item lane: segment g (rows r0 .. r0 + seg_rows - 1), chunk c of a group
  const int g = lane / lpr;
  const int c = lane - g * lpr;
  const int r0 = g * seg_rows;
  const T* pb = plane + (long long)b * ncell * F;
  T* ob = out + (base + s0) * F;
  P zero;
#pragma unroll
  for (int e = 0; e < VEC; ++e) zero.v[e] = from_f32<T>(0.0f);
  for (int cg = 0; cg < chunks; ++cg) {
    const int k = (cg * lpr + c) * VEC;  // the item's first feature
    const bool on = g < segs && k < F;
    P cur = zero;  // the latest load, divided
    for (int s = 0; s < seg_rows; s += kGatherBatch) {
      P v[kGatherBatch];
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int r = r0 + s + u;
        const int d = __shfl_sync(kFull, dst, r & 31);
        if (on && s + u < seg_rows && r < rows && (loads >> r & 1u))
          v[u] = *reinterpret_cast<const P*>(pb + (long long)d * F + k);
      }
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int r = r0 + s + u;
        const float nr = __shfl_sync(kFull, n, r & 31);
        if (!on || s + u >= seg_rows || r >= rows) continue;
        if (loads >> r & 1u) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) cur.v[e] = from_f32<T>(to_f32(v[u].v[e]) / nr);
        }
        *reinterpret_cast<P*>(ob + (long long)r * F + k) = valid >> r & 1u ? cur : zero;
      }
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
// apart (each store coalesced), their flags loaded first; an item is 16 bytes
// of a cell (vec: F a multiple of 16 / sizeof(T): four floats or eight bf16)
// or one value; q = items a cell, qshift = log2(q) when q is a power of two
// (no division), else -1. (A flag loaded once a cell and shuffled to its
// items' lanes was slower: the shuffles hold back the loads behind them.)
constexpr int kZeroItems = 4;

template <typename T>
__device__ __forceinline__ void zero_empty_cells(T* __restrict__ plane,
                                                 int* __restrict__ counts,
                                                 const uint8_t* __restrict__ flags,
                                                 unsigned block, unsigned blocks, unsigned n,
                                                 unsigned q, int qshift, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
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
      Pack<T, kVec> zero;
#pragma unroll
      for (int e = 0; e < kVec; ++e) zero.v[e] = from_f32<T>(0.0f);
      *reinterpret_cast<Pack<T, kVec>*>(plane + kVec * (long long)i) = zero;
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

// One row's VEC values of a lane in the run scatter, as loaded: f32 as
// floats; bf16 as the raw 32-bit words of its 16-byte, 8-byte, 4-byte or
// 2-byte load (a bf16 is the top half of its f32, so at() converts with a
// shift or a mask: exact, as __bfloat162float).
template <typename T, int VEC>
struct RowVals {
  static constexpr int kRegs = VEC;
  float v[VEC];
  __device__ __forceinline__ void load(const float* __restrict__ p) { load_vec<VEC>(p, v); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
  }
  __device__ __forceinline__ float at(int e) const { return v[e]; }
};

template <int VEC>
struct RowVals<bf16, VEC> {
  static constexpr int kRegs = VEC == 1 ? 1 : VEC / 2;
  uint32_t w[kRegs];
  __device__ __forceinline__ void load(const bf16* __restrict__ p) {
    if constexpr (VEC == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (VEC == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else if constexpr (VEC == 2) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ float at(int e) const {
    const uint32_t u = w[e >> 1];
    return __uint_as_float(e & 1 ? u & 0xffff0000u : u << 16);
  }
};

// Rows of values a lane of the run scatter loads at once (a group): 32
// registers of them, at most a span: f32 32 / VEC rows; bf16, two values a
// register, twice that from VEC = 2 on (32 rows up to 4 bytes a lane, 16 at
// 8, 8 at 16).
template <typename T, int VEC>
constexpr int kRunGroup = 32 / RowVals<T, VEC>::kRegs < kSpan ? 32 / RowVals<T, VEC>::kRegs
                                                               : kSpan;

// K3 and K4's plane (TILED false: mask) and K11-K14 (TILED true: tile offsets, no mask;
// K13 MORTON: the output in Morton order): the run part and the zero part in
// one launch, after the mark pass. The run part's
// warp = (batch entry, span, chunk of 32 * VEC features), chunk fastest, so a
// block's warps share the span's ids in L1 when there are 8 chunks or more;
// a lane loads VEC features of a row at once (f32 VEC 4: a row's 128 features
// are one 512-byte load; bf16 VEC 8 from F = 256 on: a row's 256 features are
// one 512-byte load, 16 bytes a lane). The span's rows load in groups of 32
// registers of values a lane (kRunGroup; in bf16 the raw words, two values a
// register, so twice f32's rows from VEC = 2 on) and are summed as they
// come, each run's end written at once. Three blocks an SM (<= 80
// registers).
template <typename T, bool TILED, int VEC, bool MORTON>
__global__ void __launch_bounds__(kThreads, 3)
scatter_runs(const T* __restrict__ x, const int* __restrict__ cells,
             const uint8_t* __restrict__ mask, const int* __restrict__ toff,
             T* __restrict__ plane, int* __restrict__ counts,
             const uint8_t* __restrict__ flags, int B, int N, int F, int reso, int shift,
             int toff_row, int toff_step, unsigned run_blocks, unsigned zero_blocks,
             unsigned zero_n, unsigned zero_q, int zero_qshift, bool runs_first) {
  constexpr int kGroup = kRunGroup<T, VEC>;  // rows loaded at once
  // the parts' blocks alternate while both have blocks left (none with
  // runs_first), then come the run part's rest, then the zero part's
  const unsigned pairs = runs_first ? 0u : min(run_blocks, zero_blocks);
  const bool zero_part =
      blockIdx.x < 2 * pairs ? blockIdx.x & 1u : blockIdx.x >= run_blocks + pairs;
  const unsigned part_block = blockIdx.x < 2 * pairs ? blockIdx.x >> 1
                              : zero_part            ? blockIdx.x - run_blocks
                                                     : blockIdx.x - pairs;
  if (zero_part) {
    zero_empty_cells(plane, counts, flags, part_block, zero_blocks, zero_n, zero_q,
                     zero_qshift, zero_q != static_cast<unsigned>(F));
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
    RowVals<T, VEC> v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (fin && (own >> (g + k) & 1u)) {
        v[k].load(xf + (long long)(s0 + g + k) * F);
      } else {
        v[k].zero();
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int r = g + k;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (heads >> r & 1u) acc[e] = 0.0f;
        if (own >> r & 1u) acc[e] += v[k].at(e);
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
        RowVals<T, VEC> v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (fin && (tv >> (g + k) & 1u)) {
            v[k].load(xf + (long long)(j0 + g + k) * F);
          } else {
            v[k].zero();
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (tv >> (g + k) & 1u) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += v[k].at(e);
          }
      }
      count += __popc(tv);
      if (len < kSpan) break;
      j0 += kSpan;
    }
    if (count > 0) write(kSpan - 1, acc, count);
  }
}

// pool_runs' plan at width F for values of `elem` bytes (x, out and, under
// the gate, tie_a and tie_b 16-byte aligned or not) of kind `kind`, tiled
// (K10's tile rule) or not, tile_plan.pool_runs_plan: staged (1:
// pool_runs_staged, where F is a multiple of vec and the values aligned; 0:
// pool_runs, a lane a feature), vec values a 16-byte copy, chunk features a
// step, pieces copies a row of a step, and tile_bytes, one tile's shared
// memory (a warp holds one, three under the gate). The f32 max under the
// mask (K1 max) keeps pool_runs: staged it took 1-2% longer on the H100 at
// the flagship's shape (its f32 loads already move 128 bytes a warp
// instruction; PERF.md).
struct PoolRunsPlan {
  int staged, vec, chunk, pieces, tile_bytes;
};

inline PoolRunsPlan pool_runs_plan(int F, int elem, bool aligned, int kind, bool tiled) {
  PoolRunsPlan p;
  p.vec = 16 / elem;
  p.staged = aligned && F % p.vec == 0 && !(elem == 4 && kind == 0 && !tiled) ? 1 : 0;
  p.chunk = 32;
  p.pieces = p.chunk / p.vec;
  p.tile_bytes = kSpan * p.chunk * elem;
  return p;
}

// K2 alone's plan at width F (F > 0) for values of `elem` bytes (the plane
// and the output 16-byte aligned or not), tile_plan.pool_gather_plan: items
// (1: pool_gather_items, where F is a multiple of 16 / elem and both are
// aligned; 0: pool_gather), vec values an item (1: a lane a feature), cpr
// chunks a row, lpr lanes a row (min(cpr, 32)), segs segments a span and
// seg_rows rows a segment (32 / lpr and 32 / segs, rounded up), chunks the
// chunk groups a warp walks (pool_gather: the warps a span, one each 32
// features), batch the rows whose loads go out at once.
struct PoolGatherPlan {
  int items, vec, cpr, lpr, segs, seg_rows, chunks, batch;
};

inline PoolGatherPlan pool_gather_plan(int F, int elem, bool aligned) {
  PoolGatherPlan p;
  p.items = aligned && F % (16 / elem) == 0 ? 1 : 0;
  p.vec = p.items ? 16 / elem : 1;
  p.cpr = F / p.vec;
  p.lpr = p.items && p.cpr < 32 ? p.cpr : 32;
  p.segs = p.items ? 32 / p.lpr : 1;
  p.seg_rows = (kSpan + p.segs - 1) / p.segs;
  p.chunks = (p.cpr + p.lpr - 1) / p.lpr;
  p.batch = p.items ? kGatherBatch : kGatherGroup;
  return p;
}

// pool_runs_staged with its shared memory (above 48 KB only after the opt-in:
// f32 with the gate, 96 KB a block).
template <typename T, int KIND, bool TIE, bool TILED>
cudaError_t launch_staged(unsigned blocks, int smem, cudaStream_t stream, const T* x,
                          const int* cells, const uint8_t* mask, const int* toff,
                          const T* tie_a, const T* tie_b, T* out, int B, int N, int F,
                          int ncell) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_runs_staged<T, KIND, TIE, TILED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  pool_runs_staged<T, KIND, TIE, TILED><<<blocks, kThreads, smem, stream>>>(
      x, cells, mask, toff, tie_a, tie_b, out, B, N, F, ncell);
  return cudaGetLastError();
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
  const PoolRunsPlan p = pool_runs_plan(
      F, sizeof(T),
      aligned16(x) && aligned16(out) && (!tie || (aligned16(tie_a) && aligned16(tie_b))),
      kind, tiled);
  const int smem = (kThreads / 32) * p.tile_bytes * (tie ? 3 : 1);
#define T2H_RUNS(K, TI, TL)                                                                 \
  if (p.staged) return static_cast<int>(launch_staged<T, K, TI, TL>(                       \
      blocks, smem, stream, x, cells, mask, toff, tie_a, tie_b, out, B, N, F, ncell));     \
  pool_runs<T, K, TI, TL><<<blocks, kThreads, 0, stream>>>(x, cells, mask, toff, tie_a,     \
                                                           tie_b, out, B, N, F, ncell)
  if (tiled && kind == 3) {
    T2H_RUNS(3, true, true);
  } else if (tiled && kind == 0) {
    T2H_RUNS(0, false, true);
  } else if (tiled) {
    T2H_RUNS(1, false, true);
  } else if (tie) {
    T2H_RUNS(2, true, false);
  } else if (kind == 0) {
    T2H_RUNS(0, false, false);
  } else if (kind == 1) {
    T2H_RUNS(1, false, false);
  } else {
    T2H_RUNS(2, false, false);
  }
#undef T2H_RUNS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CUT>
int launch_pool_gather(const T* plane, const int* cells, const uint8_t* mask,
                       const int* counts, T* out, int B, int N, int F, int reso, int shift,
                       cudaStream_t stream) {
  if ((long long)B * N * F <= 0) return static_cast<int>(cudaGetLastError());
  const PoolGatherPlan p = pool_gather_plan(F, sizeof(T), aligned16(plane) && aligned16(out));
  const long long spans = (N + kSpan - 1) / kSpan;
  const long long warps = (long long)B * spans * (p.items ? 1 : p.chunks);
  if (warps * 32 >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
  constexpr int kVec = 16 / sizeof(T);
  if (p.items)
    pool_gather_items<T, CUT, kVec><<<blocks, kThreads, 0, stream>>>(
        plane, cells, mask, counts, out, N, F, reso, shift, static_cast<unsigned>(warps),
        static_cast<unsigned>(spans), p.lpr, p.segs, p.seg_rows, p.chunks);
  else
    pool_gather<T, CUT><<<blocks, kThreads, 0, stream>>>(
        plane, cells, mask, counts, out, N, F, reso, shift, static_cast<unsigned>(warps),
        static_cast<unsigned>(spans), static_cast<unsigned>(p.chunks));
  return static_cast<int>(cudaGetLastError());
}

// The run scatter's plan at width F for values of `elem` bytes (16-byte
// aligned or not), tile_plan.scatter_runs_plan: features a lane of the run
// part (vec: in bf16 8 from F = 256 on; 4 from F = 128 on, 2 from 64, 1 for
// unaligned values), feature chunks a span (warps), rows a group
// (kRunGroup), values a zero item (16 bytes where F is a multiple of it,
// else 1), items a cell q and log2(q) (-1 when q is no power of two).
struct RunsPlan {
  int vec, chunks, group, item, q, qshift;
};

inline RunsPlan runs_plan(int F, int elem, bool aligned) {
  RunsPlan p;
  p.vec = !aligned                              ? 1
          : elem == 2 && F % 8 == 0 && F >= 256 ? 8
          : F % 4 == 0 && F >= 128              ? 4
          : F % 2 == 0 && F >= 64               ? 2
                                                : 1;
  p.chunks = (F + 32 * p.vec - 1) / (32 * p.vec);
  const int regs = elem == 2 && p.vec > 1 ? p.vec / 2 : p.vec;  // RowVals::kRegs
  p.group = 32 / regs < kSpan ? 32 / regs : kSpan;
  p.item = F % (16 / elem) == 0 ? 16 / elem : 1;
  p.q = F / p.item;
  p.qshift = p.q > 0 && (p.q & (p.q - 1)) == 0 ? __builtin_ctz(p.q) : -1;
  return p;
}

// The steps of a run scatter, for timing them apart (t2h_scatter_runs_parts):
// clear the flags, mark, the run part, the zero part.
constexpr int kClear = 1, kMark = 2, kRuns = 4, kZeros = 8, kAllParts = 15;

template <typename T>
int launch_scatter_runs(const T* values, const int* cells, const uint8_t* mask,
                        const int* toff, T* plane, int* counts, uint8_t* flags, int B, int N,
                        int F, int reso, int shift, int toff_row, int toff_step, int morton,
                        int parts, cudaStream_t stream) {
  const bool tiled = toff != nullptr;
  const long long ncells = (long long)B * reso * reso;
  const RunsPlan p = runs_plan(F, sizeof(T), aligned16(values));
  const long long items = ncells * p.q;
  if (F < 0 || tiled == (mask != nullptr) || (!tiled && counts == nullptr) ||
      items >= (1LL << 31) || (morton && (!tiled || counts != nullptr)) ||
      (tiled && ((reso * reso) % 256 != 0 || toff_step < 1 ||
                 toff_row < (reso * reso / 256) * toff_step + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return static_cast<int>(cudaGetLastError());
  if (parts & kClear) {
    const cudaError_t err = cudaMemsetAsync(flags, 0, ncells, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((parts & kMark) && N > 0) {
    const dim3 grid((N + kThreads - 1) / kThreads, B);
#define T2H_MARK(TI, M)                                                                   \
  mark_cells<TI, M><<<grid, kThreads, 0, stream>>>(cells, mask, toff, flags, N, reso, shift, \
                                                   toff_row, toff_step)
    if (morton) T2H_MARK(true, true);
    else if (tiled) T2H_MARK(true, false);
    else T2H_MARK(false, false);
#undef T2H_MARK
  }
  const long long threads = (long long)B * ((N + kSpan - 1) / kSpan) * p.chunks * 32;
  const unsigned run_blocks =
      parts & kRuns ? static_cast<unsigned>((threads + kThreads - 1) / kThreads) : 0u;
  const unsigned zero_blocks =
      parts & kZeros
          ? static_cast<unsigned>((items + kThreads * kZeroItems - 1) / (kThreads * kZeroItems))
          : 0u;
  if (run_blocks + zero_blocks == 0) return static_cast<int>(cudaGetLastError());
  // the run blocks first where the level has no more cells than rows (its
  // zero part is small and fills the run part's tail), else the two parts'
  // blocks alternating
  const bool runs_first = reso * reso <= N;
#define T2H_SCATTER_RUNS(TI, V, M)                                                        \
  scatter_runs<T, TI, V, M><<<run_blocks + zero_blocks, kThreads, 0, stream>>>(           \
      values, cells, mask, toff, plane, counts, flags, B, N, F, reso, shift, toff_row,    \
      toff_step, run_blocks, zero_blocks, static_cast<unsigned>(items), p.q, p.qshift,    \
      runs_first)
#define T2H_SCATTER_WIDTHS(TI, M)                                 \
  if (p.vec == 8) {                                               \
    if constexpr (kIsBf16<T>) T2H_SCATTER_RUNS(TI, 8, M);         \
  } else if (p.vec == 4) T2H_SCATTER_RUNS(TI, 4, M);              \
  else if (p.vec == 2) T2H_SCATTER_RUNS(TI, 2, M);                \
  else T2H_SCATTER_RUNS(TI, 1, M)
  if (morton) {
    T2H_SCATTER_WIDTHS(true, true);
  } else if (tiled) {
    T2H_SCATTER_WIDTHS(true, false);
  } else {
    T2H_SCATTER_WIDTHS(false, false);
  }
#undef T2H_SCATTER_WIDTHS
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
                             shift, toff_row, toff_step, morton, kAllParts, stream);
}

// The run scatter's plan at width F (F > 0) for values of `elem` bytes,
// 16-byte aligned or not: vec, chunks, group, item, q, qshift to out[0..5].
int t2h_scatter_runs_plan(int F, int elem, int aligned, int* out) {
  const RunsPlan p = runs_plan(F, elem, aligned != 0);
  const int v[] = {p.vec, p.chunks, p.group, p.item, p.q, p.qshift};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// pool_runs' plan at width F (F > 0) for values of `elem` bytes, aligned or
// not, of kind `kind` (0 max, 1 mean, 2 sum, 3 tied sum), tiled or not:
// staged, vec, chunk, pieces, tile_bytes to out[0..4].
int t2h_pool_runs_plan(int F, int elem, int aligned, int kind, int tiled, int* out) {
  const PoolRunsPlan p = pool_runs_plan(F, elem, aligned != 0, kind, tiled != 0);
  const int v[] = {p.staged, p.vec, p.chunk, p.pieces, p.tile_bytes};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// K2 alone's plan at width F (F > 0) for values of `elem` bytes, aligned or
// not: items, vec, cpr, lpr, segs, seg_rows, chunks, batch to out[0..7].
int t2h_pool_gather_plan(int F, int elem, int aligned, int* out) {
  const PoolGatherPlan p = pool_gather_plan(F, elem, aligned != 0);
  const int v[] = {p.items, p.vec, p.cpr, p.lpr, p.segs, p.seg_rows, p.chunks, p.batch};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The same launching only the steps in `parts` (bits: 1 clear the flags, 2
// mark, 4 the run part, 8 the zero part), for timing them apart
// (tools/time_scatter.py --parts); parts 15 is t2h_scatter_runs.
int t2h_scatter_runs_parts(const float* values, const int* cells, const uint8_t* mask,
                           const int* toff, float* plane, int* counts, uint8_t* flags, int B,
                           int N, int F, int reso, int shift, int toff_row, int toff_step,
                           int morton, int parts, cudaStream_t stream) {
  return launch_scatter_runs(values, cells, mask, toff, plane, counts, flags, B, N, F, reso,
                             shift, toff_row, toff_step, morton, parts, stream);
}

// The same on bf16 values and plane (K3 and K4's plane in the model's bf16
// dtype, JAX pool2_kernel.py:292-334, level_kernel.py:281-310): each run's
// row-order sum in f32, its mean rounded to bf16 once.
int t2h_scatter_runs_bf16(const bf16* values, const int* cells, const uint8_t* mask,
                          const int* toff, bf16* plane, int* counts, uint8_t* flags, int B,
                          int N, int F, int reso, int shift, int toff_row, int toff_step,
                          int morton, cudaStream_t stream) {
  return launch_scatter_runs(values, cells, mask, toff, plane, counts, flags, B, N, F, reso,
                             shift, toff_row, toff_step, morton, kAllParts, stream);
}

int t2h_scatter_runs_parts_bf16(const bf16* values, const int* cells, const uint8_t* mask,
                                const int* toff, bf16* plane, int* counts, uint8_t* flags,
                                int B, int N, int F, int reso, int shift, int toff_row,
                                int toff_step, int morton, int parts, cudaStream_t stream) {
  return launch_scatter_runs(values, cells, mask, toff, plane, counts, flags, B, N, F, reso,
                             shift, toff_row, toff_step, morton, parts, stream);
}

}  // extern "C"
