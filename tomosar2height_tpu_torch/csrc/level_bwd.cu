// One ALTO level round trip, backward: the Hopper version of _level_bwd_kernel
// in tomosar2height_tpu/ops/pallas/level_bwd_kernel.py (launched by
// fused_level_bwd_call). It is the backward of K4 (level.cu).
//
// Per valid row, f32 (level_bwd_kernel.py:193-285):
//   recompute s = bilinear(plane) (border clamp, align_corners; the +1
//   neighbour clamped with weight 0, exactly as K4), pre = s W_in + b_in,
//   h = relu(pre);
//   d_o = (g_c + g_plane[cell] / max(count, 1)) * valid;
//   d_h = (d_o W_out^T) * [pre > 0];  d_s = d_h W_in^T;  d_c_last = d_o W_c^T;
//   d_plane += bilinear-transpose(d_s);
//   dW_in = sum s^T d_h, db_in = sum d_h, dW_out = sum h^T d_o,
//   db_out = db_c = sum d_o, dW_c = sum c_last^T d_o.
// Pad rows (mask 0, cells 1<<30) contribute nothing.
//
// The TPU kernel walks a sequential (batch, chunk) grid and accumulates the
// weight gradients in revisited VMEM output blocks, and the plane gradient in
// per-tile halo windows folded back XLA-side (windows_to_plane). Blocks on the
// card run in parallel and in no order, so the work is split in three
// phases, each writing every output element once, in a fixed order, with no
// atomics: K5 is bit-equal run to run.
//
// 1. fused_level_bwd_rows: a block owns kRB = 64 consecutive rows, and its
//    four contractions run on the tensor cores at fp32 accuracy (3xTF32
//    mma.sync, mma_tf32x3.cuh; K4's warp layout and chain-length rule). The
//    shared A buffer [64][F] holds the sample s, then d_o. In order, each
//    weight tile arriving through one cp.async ring:
//      a. per 64-column chunk of the hidden layer: pre = s W_in[:, chunk]
//         into registers; h = relu(pre + b_in) to scratch, and each thread
//         keeps its elements' gates [pre > 0] as bits in shared memory;
//      b. d_o -> the A buffer; d_c_last = d_o W_c^T in column chunks of F's
//         width, straight from registers to global;
//      c. per hidden chunk: d_h = (d_o W_out^T[:, chunk]) * gate to scratch
//         and a shared 64 x 64 tile, then d_s += d_h W_in^T[chunk, :] in
//         registers (a warp owns 32 rows x F/8 or F/4 columns of d_s, as K4
//         its o). The hidden layer (2F floats a row) never exists whole in
//         shared memory, so 64 rows fit at F = 512 (219 KB).
//    The rows' s, h, d_o, d_h and d_s go to scratch (M x 7F floats, M = B*N
//    rows): s, h, d_o and d_h for phase 2, d_s for phase 3.
// 2. t2h_level_bwd_reduce (atb_mma + sum_splits), three calls: each
//    weight gradient is A^T B over all M rows, split-K on the tensor cores
//    at fp32 accuracy (3xTF32 mma.sync, mma_tf32x3.cuh): a block owns one
//    128 x 128 output tile (64 where Ka or Nb is 64 or less) and one
//    contiguous row split, its rows streamed through a 3-stage cp.async
//    ring of 32-row steps; the blocks of the first k-tile also sum the
//    columns of the B tiles they hold (the bias gradient), and a second pass
//    sums the splits in a fixed order.
// 3. t2h_level_d_plane (cell_rows + d_plane_tiles): d_plane, the bilinear
//    transpose of d_s, gathered by its pixels. Pixel (px, py) receives from
//    the rows whose corner has x0 in {px-1, px} and y0 in {py-1, py}, so u *
//    (R-1) in [px-1, px+1): their finest cells (the host's trunc(u * fr),
//    fr the finest resolution) lie in a rectangle, widened by one cell on
//    each side against rounding (cell_span). A mark pass writes each finest
//    cell's row range [start, end) (its rows are contiguous on the aligned
//    layout: the run head writes start, the run tail end); a block owns a
//    tile of pixels and a chunk of features, walks the cells under the
//    union of its pixels' rectangles in row-major order and each cell's
//    rows in row order (each row's corner computed once, its d_s line read
//    once into shared memory), and each pixel adds w * d_s of the rows of
//    its own rectangle whose corner touches it, in that order: each pixel
//    written once, from the fixed-order sum a walk of its own rectangle
//    takes.
//
// Bound on the H100: the MACs. A row costs 10F^2 + 2F*Fl MAC (6F^2 + F*Fl
// in phase 1, 4F^2 + F*Fl in phase 2), three TF32 products each, ~2.9M at
// the F=512 level, 2.4x K4's forward. 64 rows a block halve the weight
// reads from L2 of the 32-row blocks the row pass had on fp32 FMA (6.8 MB a
// block at F = 512). Phase 2's scratch rows are read once per output-tile
// column or row (128-wide tiles: 4-8 times at F=512, mostly from L2, since
// the blocks of one split run side by side). Phase 1's shared memory does
// not grow with Fl (d_c_last leaves each column chunk from registers), so
// the Fl = 1024 level of a depth-6 U-Net fits as it is. What holds phase 1
// back (ablations on the card, PERF.md): its two products into a 64-column
// hidden chunk (pre, d_o W_out^T) give each warp one or two n-tiles a k8
// step, so the operand splits outweigh the MMAs there; F-wide chunks with
// d_h read back from scratch spilled at F = 512 and ran slower at F = 256.
// bf16 (t2h_*_bf16): bf16 inputs, scratch rows and outputs, f32
// accumulators, the JAX kernel's rounding points (level_bwd_kernel.py:
// 206-256). Phase 1 in bf16 is level_bwd_bf16.cu's (TMA and wgmma: s and
// pre recomputed as K4's bf16 instance, the relu gate from the rounded pre,
// d_o = bf16(g_c + bf16(g_plane / count)), d_h, d_s and d_c_last each
// rounded once from their f32 products); fused_level_bwd_rows here is f32
// only. Phase 2 in bf16 is reduce_bf16.cu's (t2h_level_bwd_reduce_bf16:
// TMA and wgmma, the f32 sums rounded to bf16 once); phase 3 cuts each
// corner weight to bf16 as the forward does and rounds each pixel's f32
// sum once (JAX rounds each tile's halo window, then folds the windows in
// bf16: a deliberate difference, tests/test_torch_bf16_sorted.py).
//
// Phase 3 is bound by bytes (d_s on the valid rows, d_plane written once).
// A warp a pixel read each row's d_s once for each pixel whose rectangle
// holds it (4-9 of them), recomputed its corner as often, and walked its
// rectangle as a chain of dependent loads (offsets, rows, corners, d_s);
// a tile's block reads each row's line once (the tiles' rectangles overlap
// by their margins) in three dependent steps a walk step.

#include <algorithm>

#include "bilinear.cuh"
#include "mma_bf16.cuh"

namespace t2h {

constexpr int kRM = 32;      // rows per reduction step
constexpr int kRStages = 3;  // reduction steps in flight

constexpr int kRB = 64;   // rows per row-pass block
constexpr int kRHC = 64;  // hidden columns per chunk

// Per width class FP (F rounded up to a power of two >= 32), K4's layout
// (level.cu LevelCfg): 512 threads at F = 128 and 512 (128 registers), 256
// threads at the others (two blocks an SM at F <= 64); warps are 2 row
// halves x kWQ column groups, of d_c_last / d_s and of the hidden chunk
// alike. Each thread keeps kGate gate bits per hidden chunk (its elements
// of the chunk), packed in kGateWords words of shared memory.
// T = bf16: bf16 tiles, strides of 8 (mod 64) elements (level.cu LevelCfg).
template <typename T, int FP>
struct RowCfg {
  static constexpr int kT = FP == 128 || FP == 512 ? 512 : 256;
  static constexpr int kWQ = kT / 64;
  static constexpr int kWN = FP / kWQ;  // a warp's d_s / d_c_last columns
  static constexpr int kNT = kWN / 8;
  static constexpr int kWH = kRHC / kWQ;  // a warp's hidden-chunk columns
  static constexpr int kNT1 = kWH / 8;
  static constexpr int kKS1 = FP >= 64 ? 64 : 32;   // w_in / w_out^T tile rows
  static constexpr int kKS2 = FP >= 256 ? 16 : 32;  // w_c^T / w_in^T tile rows
  static constexpr int kPadA = kIsBf16<T> ? 8 : 4;
  static constexpr int kLdA = FP + kPadA;    // A buffer: s, then d_o
  static constexpr int kLdH = kRHC + kPadA;  // d_h chunk
  static constexpr int kLdW1 = kRHC + 8;  // w_in / w_out^T tile
  static constexpr int kLdW2 = FP + 8;    // w_c^T / w_in^T tile
  static constexpr int kSlot = kKS1 * kLdW1 > kKS2 * kLdW2 ? kKS1 * kLdW1 : kKS2 * kLdW2;
  static constexpr int kStages = FP >= 512 ? 2 : 3;
  static constexpr int kMinBlocks = FP >= 128 ? 1 : 2;
  static constexpr int kGate = 2 * kNT1 * 4;
  static constexpr int kGateWords = (2 * FP / kRHC * kGate + 31) / 32;
  static constexpr size_t kSmem =
      sizeof(T) * ((size_t)kRB * kLdA + (size_t)kRB * kLdH + (size_t)kStages * kSlot) +
      sizeof(uint32_t) * (size_t)kGateWords * kT;
  static_assert(kKS1 <= FP && FP % kKS1 == 0 && kKS2 <= FP && FP % kKS2 == 0 &&
                    kRHC % kKS2 == 0 && 32 % kGate == 0,
                "tiles must not reach past the A buffer or a chunk");
};

template <typename T, int FP>
__global__ void __launch_bounds__(RowCfg<T, FP>::kT, RowCfg<T, FP>::kMinBlocks)
fused_level_bwd_rows(const T* __restrict__ plane, const float* __restrict__ xy,
                     const int* __restrict__ cells, const uint8_t* __restrict__ mask,
                     const int* __restrict__ counts, const T* __restrict__ g_plane,
                     const T* __restrict__ g_c, const T* __restrict__ w_in,
                     const T* __restrict__ b_in, const T* __restrict__ w_out_t,
                     const T* __restrict__ w_c_t, const T* __restrict__ w_in_t,
                     T* __restrict__ d_clast, T* __restrict__ s_buf, T* __restrict__ h_buf,
                     T* __restrict__ do_buf, T* __restrict__ dh_buf, T* __restrict__ ds_buf,
                     int N, int R, int F, int Fl, int shift, bool vec_h, bool vec_f,
                     bool vec_l) {
  using C = RowCfg<T, FP>;
  extern __shared__ float4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);  // [kRB][kLdA]: s, then d_o
  T* Hs = As + kRB * C::kLdA;           // [kRB][kLdH]: a d_h chunk
  T* ring = Hs + kRB * C::kLdH;         // [kStages][kSlot]: weight tiles
  uint32_t* gate = reinterpret_cast<uint32_t*>(ring + C::kStages * C::kSlot);  // [words][kT]
  const T zero = from_f32<T>(0.0f);

  __shared__ int s_valid[kRB];
  __shared__ int s_cell[kRB];  // row-major cell at this level, -1 if none
  __shared__ Corner s_corner[kRB];
  __shared__ float s_cnt[kRB];  // max(count, 1) of the row's cell
  __shared__ int s_any;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / C::kWQ) * 32;
  const int wq = warp % C::kWQ;
  const int g = lane >> 2, q = lane & 3;
  const int H = 2 * F;
  const long long RR = (long long)R * R;

  if (tid == 0) s_any = 0;
  __syncthreads();
  if (tid < kRB) {
    const int i = i0 + tid;
    int valid = 0, cellr = -1;
    float cnt = 1.0f;
    Corner corner = {};
    if (i < N) {
      const long long p = (long long)b * N + i;
      valid = mask[p] != 0;
      if (valid) {
        corner = bilinear_corner(xy[2 * p], xy[2 * p + 1], R);
        const int c = cells[p];
        if (c >= 0 && (c >> shift) < RR) {
          cellr = morton_to_rowmajor(c >> shift, R);
          const int n = counts[(long long)b * RR + cellr];
          cnt = static_cast<float>(n > 1 ? n : 1);
        }
        s_any = 1;
      }
    }
    s_valid[tid] = valid;
    s_cell[tid] = cellr;
    s_corner[tid] = corner;
    s_cnt[tid] = cnt;
  }
  __syncthreads();

  const long long rowb = (long long)b * N + i0;  // global row of the block's row 0
  const int rows = min(kRB, N - i0);
  if (!s_any) {  // all rows are padding: every output and scratch row is 0
    for (int e = tid; e < rows * H; e += C::kT) {
      h_buf[rowb * H + e] = zero;
      dh_buf[rowb * H + e] = zero;
    }
    for (int e = tid; e < rows * F; e += C::kT) {
      s_buf[rowb * F + e] = zero;
      do_buf[rowb * F + e] = zero;
      ds_buf[rowb * F + e] = zero;
    }
    for (int e = tid; e < rows * Fl; e += C::kT) d_clast[rowb * Fl + e] = zero;
    return;
  }

  // --- the bilinear sample -> As (zeros past F and on padding), scratch s ------
  const T* pl = plane + (long long)b * RR * F;
  for (int e = tid; e < kRB * FP; e += C::kT) {
    const int r = e / FP;
    const int c = e - r * FP;
    const T v = from_f32<T>(
        c < F && r < rows && s_valid[r] ? bilinear_at(pl, s_corner[r], R, F, c) : 0.0f);
    As[r * C::kLdA + c] = v;
    if (c < F && r < rows) s_buf[(rowb + r) * F + c] = v;
  }

  // The tile sequence: (a) nH chunks of n1 w_in tiles (kKS1 x kRHC); (b) nJ
  // column chunks of nK w_c^T tiles (kKS2 x FP); (c) nH chunks of n1 w_out^T
  // tiles (kKS1 x kRHC) and n2 w_in^T tiles (kKS2 x FP).
  const int n1 = (F + C::kKS1 - 1) / C::kKS1;
  const int nK = (F + C::kKS2 - 1) / C::kKS2;
  constexpr int n2 = kRHC / C::kKS2;
  const int nH = (H + kRHC - 1) / kRHC;
  const int nJ = (Fl + FP - 1) / FP;
  const int TA = nH * n1;
  const int TB = TA + nJ * nK;
  const int n_tiles = TB + nH * (n1 + n2);
  // kind 0: w_in (a), 1: w_c^T (b), 2: w_out^T (c), 3: w_in^T (c); c: the
  // hidden (or column) chunk, v: the tile within it
  auto decode = [&](int t, int& kind, int& c, int& v) {
    if (t < TA) {
      kind = 0;
      c = t / n1;
      v = t - c * n1;
    } else if (t < TB) {
      kind = 1;
      c = (t - TA) / nK;
      v = t - TA - c * nK;
    } else {
      const int u = t - TB;
      c = u / (n1 + n2);
      v = u - c * (n1 + n2);
      kind = v < n1 ? 2 : 3;
      if (kind == 3) v -= n1;
    }
  };
  auto issue = [&](int t) {
    if (t < n_tiles) {
      T* slot = ring + (t % C::kStages) * C::kSlot;
      int kind, c, v;
      decode(t, kind, c, v);
      if (kind == 0 || kind == 2) {
        cp_tile<C::kKS1, kRHC, C::kT>(slot, C::kLdW1, kind == 0 ? w_in : w_out_t, H,
                                      v * C::kKS1, F, c * kRHC, H, vec_h, tid);
      } else if (kind == 1) {
        cp_tile<C::kKS2, FP, C::kT>(slot, C::kLdW2, w_c_t, Fl, v * C::kKS2, F, c * FP, Fl,
                                    vec_l, tid);
      } else {
        cp_tile<C::kKS2, FP, C::kT>(slot, C::kLdW2, w_in_t, F, c * kRHC + v * C::kKS2, H, 0,
                                    F, vec_f, tid);
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

  float acc[2][C::kNT][4];    // d_c_last chunk, then d_s: rows wm.., columns wq * kWN..
  float hacc[2][C::kNT1][4];  // pre or d_o W_out^T chunk: rows wm.., columns wq * kWH..
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    int kind, c, v;
    decode(t, kind, c, v);
    if (t == TA) {  // d_o = (g_c + g_plane[cell] / count) * valid -> As, scratch d_o
      // (bf16: the quotient rounded, then the sum: level_bwd_kernel.py:228-243)
      __syncthreads();  // every warp is done with the sample
      const T* gp = g_plane + (long long)b * RR * F;
      for (int e = tid; e < kRB * FP; e += C::kT) {
        const int r = e / FP;
        const int cc = e - r * FP;
        float x = 0.0f;
        if (cc < F && r < rows && s_valid[r]) {
          x = to_f32(g_c[(rowb + r) * F + cc]);
          if (s_cell[r] >= 0)
            x += round_as<T>(to_f32(gp[(long long)s_cell[r] * F + cc]) / s_cnt[r]);
        }
        As[r * C::kLdA + cc] = from_f32<T>(x);
        if (cc < F && r < rows) do_buf[(rowb + r) * F + cc] = from_f32<T>(x);
      }
    }
    if (v == 0 && kind != 3) {
      if (kind == 1 || (kind == 2 && c == 0)) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
      }
      if (kind != 1) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNT1; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) hacc[mt][nt][i] = 0.0f;
      }
    }
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t - 1's slot is free
    issue(t + C::kStages - 1);
    const T* W = ring + (t % C::kStages) * C::kSlot;
    if (kind == 1) {
      if constexpr (kIsBf16<T>) {  // no clip: the tile's columns past Fl are zeros
        warp_mma_bf16<C::kKS2, C::kNT>(acc, As + v * C::kKS2, C::kLdA, W, C::kLdW2, wm,
                                       wq * C::kWN, lane);
      } else {
        warp_mma<C::kKS2, C::kNT, true>(acc, As + v * C::kKS2, C::kLdA, W, C::kLdW2, wm,
                                        wq * C::kWN, lane, Fl - c * FP);
      }
      if (v == nK - 1) {  // d_c_last's column chunk c -> global
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = wm + mt * 16 + g + (i >> 1) * 8;
            if (r >= rows) continue;
            T* crow = d_clast + (rowb + r) * Fl;
#pragma unroll
            for (int nt = 0; nt < C::kNT; ++nt) {
              const int n = c * FP + wq * C::kWN + nt * 8 + 2 * q + (i & 1);
              if (n < Fl) crow[n] = from_f32<T>(acc[mt][nt][i]);
            }
          }
      }
    } else if (kind == 3) {
      warp_mma_t<C::kKS2, C::kNT>(acc, Hs + v * C::kKS2, C::kLdH, W, C::kLdW2, wm,
                                  wq * C::kWN, lane);
    } else {
      warp_mma_t<C::kKS1, C::kNT1>(hacc, As + v * C::kKS1, C::kLdA, W, C::kLdW1, wm,
                                   wq * C::kWH, lane);
      if (v == n1 - 1) {
        // (a) h = relu(pre + b_in) -> scratch, gates -> bits; (c) d_h =
        // (d_o W_out^T) * gate -> scratch and Hs (0 past 2F)
        const int pos = c * C::kGate;
        uint32_t* word = gate + (pos >> 5) * C::kT + tid;
        uint32_t bits = kind == 0 ? 0u : *word >> (pos & 31);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNT1; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = (mt * C::kNT1 + nt) * 4 + i;
              const int r = wm + mt * 16 + g + (i >> 1) * 8;
              const int col = wq * C::kWH + nt * 8 + 2 * q + (i & 1);
              const int n = c * kRHC + col;
              if (kind == 0) {
                // bf16: the product rounded, then the bias add (K4's pre)
                const float pre =
                    n < H ? round_as<T>(round_as<T>(hacc[mt][nt][i]) + to_f32(b_in[n])) : 0.0f;
                if (pre > 0.0f) bits |= 1u << e;
                if (r < rows && n < H) h_buf[(rowb + r) * H + n] = from_f32<T>(fmaxf(pre, 0.0f));
              } else {
                const T d = from_f32<T>((bits >> e) & 1u ? hacc[mt][nt][i] : 0.0f);
                Hs[r * C::kLdH + col] = d;
                if (r < rows && n < H) dh_buf[(rowb + r) * H + n] = d;
              }
            }
        if (kind == 0) *word = (pos & 31) == 0 ? bits : *word | bits << (pos & 31);
      }
    }
  }
  cp_async_wait<0>();

  // --- d_s (acc) -> scratch, for the d_plane pass ---------------------------------
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + mt * 16 + g + (i >> 1) * 8;
      if (r >= rows) continue;
      T* drow = ds_buf + (rowb + r) * F;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        const int n = wq * C::kWN + nt * 8 + 2 * q + (i & 1);
        if (n < F) drow[n] = from_f32<T>(acc[mt][nt][i]);
      }
    }
}

template <typename T, int FP>
cudaError_t launch_rows(const T* plane, const float* xy, const int* cells, const uint8_t* mask,
                        const int* counts, const T* g_plane, const T* g_c, const T* w_in,
                        const T* b_in, const T* w_out_t, const T* w_c_t, const T* w_in_t,
                        T* d_clast, T* s_buf, T* h_buf, T* do_buf, T* dh_buf, T* ds_buf, int B,
                        int N, int R, int F, int Fl, int shift, cudaStream_t stream) {
  using C = RowCfg<T, FP>;
  cudaError_t err = cudaFuncSetAttribute(fused_level_bwd_rows<T, FP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  constexpr int kV = 16 / sizeof(T);  // elements of a 16-byte copy
  const bool vec_h = (2 * F) % kV == 0 && aligned16(w_in) && aligned16(w_out_t);
  const bool vec_f = F % kV == 0 && aligned16(w_in_t);
  const bool vec_l = Fl % kV == 0 && aligned16(w_c_t);
  const dim3 grid((N + kRB - 1) / kRB, B);
  fused_level_bwd_rows<T, FP><<<grid, C::kT, C::kSmem, stream>>>(
      plane, xy, cells, mask, counts, g_plane, g_c, w_in, b_in, w_out_t, w_c_t, w_in_t,
      d_clast, s_buf, h_buf, do_buf, dh_buf, ds_buf, N, R, F, Fl, shift, vec_h, vec_f, vec_l);
  return cudaGetLastError();
}

// part[split][k][n] = sum over the split's rows m of A[m][k] * Bm[m][n] on
// the tensor cores (3xTF32, mma_tf32x3.cuh), k < Ka; with a bias (Kout ==
// Ka + 1) the blocks of the first k-tile also sum the columns of the Bm
// tiles they hold into part row Ka. Block: one BK x BN output tile, one
// split; the split's rows stream through a ring of kRStages shared stages of
// kRM rows (cp.async, so the next steps' loads fly during this step's MMAs).
// A warp's 32 x 64 output tile is held twice (the running sum and a step's
// chain), ~220 registers (ptxas): one block of 8 warps an SM.
// A stage holds A's rows column-major for the MMA (A^T is the left operand)
// and Bm's rows row-major, both padded to a stride of 8 (mod 32) floats.
constexpr int kRThreads = 256;  // threads of a reduction block

template <int BK, int BN>
struct ReduceTile {
  static constexpr int kWarpsK = BK >= 128 ? 4 : 2;
  static constexpr int kWarpsN = kRThreads / 32 / kWarpsK;
  static constexpr int kWK = BK / kWarpsK;  // a warp's output rows (32)
  static constexpr int kWN = BN / kWarpsN;  // and columns
  static constexpr int kMT = kWK / 16;
  static constexpr int kNT = kWN / 8;
  static constexpr int kLdA = BK + 8;
  static constexpr int kLdB = BN + 8;
  static constexpr int kStage = kRM * (kLdA + kLdB);
  static constexpr size_t kSmem = sizeof(float) * kRStages * kStage;
};

template <int BK, int BN>
__global__ void __launch_bounds__(kRThreads, 1)
atb_mma(const float* __restrict__ A, const float* __restrict__ Bm, long long M, int Ka, int Nb,
        long long rows_per_split, int Kout, bool vec_a, bool vec_b, float* __restrict__ part) {
  using T = ReduceTile<BK, BN>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float s_bias[kRThreads];
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BK;
  const long long m_begin = blockIdx.z * rows_per_split;
  const long long m_end = min(M, m_begin + rows_per_split);
  const int steps = m_end > m_begin ? static_cast<int>((m_end - m_begin + kRM - 1) / kRM) : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wk = (warp / T::kWarpsN) * T::kWK;
  const int wn = (warp % T::kWarpsN) * T::kWN;
  const bool bias = Kout > Ka && blockIdx.y == 0;
  constexpr int kBRows = kRM * BN / kRThreads;  // rows of a stage each thread sums
  const int bcol = tid % BN;
  const int brow = (tid / BN) * kBRows;

  auto issue = [&](int s) {
    if (s < steps) {
      float* st = sm + (s % kRStages) * T::kStage;
      const long long m0 = m_begin + (long long)s * kRM;
      cp_tile<kRM, BK, kRThreads>(st, T::kLdA, A, Ka, m0, m_end, k0, Ka, vec_a, tid);
      cp_tile<kRM, BN, kRThreads>(st + kRM * T::kLdA, T::kLdB, Bm, Nb, m0, m_end, n0, Nb,
                                  vec_b, tid);
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

  float acc[T::kMT][T::kNT][4] = {};
  float bsum = 0.0f;
#pragma unroll
  for (int s = 0; s < kRStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRStages - 2>();
    __syncthreads();  // step s landed for every thread; step s - 1's slot is free
    issue(s + kRStages - 1);
    const float* As = sm + (s % kRStages) * T::kStage;
    const float* Bs = As + kRM * T::kLdA;
    // the step's k8 (k16) steps chain in the tensor cores into tmp, which
    // joins acc by a rounded add (mma_tf32x3.cuh)
    float tmp[T::kMT][T::kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kRM; kk += 8) {
      FragA a[T::kMT];
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
        load_a_col(a[mt], As + kk * T::kLdA + wk + mt * 16, T::kLdA, lane);
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        FragB bf;
        load_b(bf, Bs + kk * T::kLdB + wn + nt * 8, T::kLdB, lane);
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) mma3(tmp[mt][nt], a[mt], bf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) add4(acc[mt][nt], tmp[mt][nt]);
    if (bias) {
#pragma unroll
      for (int r = 0; r < kBRows; ++r) bsum += Bs[(brow + r) * T::kLdB + bcol];
    }
  }
  cp_async_wait<0>();

  float* out = part + (long long)blockIdx.z * Kout * Nb;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + wk + mt * 16 + g + (i >> 1) * 8;
        const int n = n0 + wn + nt * 8 + 2 * t + (i & 1);
        if (k < Ka && n < Nb) out[(long long)k * Nb + n] = acc[mt][nt][i];
      }
  if (bias) {  // the column sums' partial rows, added in a fixed order
    s_bias[tid] = bsum;
    __syncthreads();
    if (tid < BN && n0 + tid < Nb) {
      float v = 0.0f;
      for (int p = 0; p < kRThreads / BN; ++p) v += s_bias[p * BN + tid];
      out[(long long)Ka * Nb + n0 + tid] = v;
    }
  }
}

template <int BK, int BN>
cudaError_t launch_atb(const float* A, const float* Bm, int M, int Ka, int Nb, int Kout,
                       int splits, float* part, cudaStream_t stream) {
  using T = ReduceTile<BK, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      atb_mma<BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const long long rps = ((long long)M + splits - 1) / splits;
  const dim3 grid((Nb + BN - 1) / BN, (Ka + BK - 1) / BK, splits);
  const bool vec_a = Ka % 4 == 0 && aligned16(A);  // 16-byte copies of 4 floats
  const bool vec_b = Nb % 4 == 0 && aligned16(Bm);
  atb_mma<BK, BN><<<grid, kRThreads, T::kSmem, stream>>>(A, Bm, M, Ka, Nb, rps, Kout,
                                                               vec_a, vec_b, part);
  return cudaGetLastError();
}

// Sum the splits in order: rows k < Ka -> dw (Ka x Nb), row Ka -> db (Nb).
__global__ void sum_splits(const float* __restrict__ part, int splits, int Ka, int Kout,
                           int Nb, float* __restrict__ dw, float* __restrict__ db) {
  const long long n_out = (long long)Kout * Nb;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n_out;
       t += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * n_out + t];
    const int k = static_cast<int>(t / Nb);
    if (k < Ka) {
      dw[t] = s;
    } else {
      db[t - (long long)Ka * Nb] = s;
    }
  }
}

// --- phase 3: d_plane, gathered by its pixels ------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMargin = 1;  // finest cells added on each side of a pixel's rectangle

// The mark pass: each finest cell's row range [start, end) in batch entry
// blockIdx.y, at the cell's row-major index (a thread a row). A cell's rows
// are contiguous (one run), so only its first row writes start and only its
// last writes end; cells with no row keep the zeros the entry point's memset
// left. Rows whose cell is out of range (pads) mark nothing.
__global__ void cell_rows(const int* __restrict__ cells, int* __restrict__ start,
                          int* __restrict__ end, int N, int fr) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long b = blockIdx.y;
  const int* cb = cells + b * N;
  const int c = cb[row];
  const int ncell = fr * fr;
  if (c < 0 || c >= ncell) return;
  const long long at = b * ncell + morton_to_rowmajor(c, fr);
  if (row == 0 || cb[row - 1] != c) start[at] = row;
  if (row == N - 1 || cb[row + 1] != c) end[at] = row + 1;
}

// The finest cells [lo, hi] along one axis that can hold a row whose corner
// touches pixel p of R: x0 in {p - 1, p} means u * (R - 1) in [p - 1, p + 1),
// so the row's cell trunc(u * fr) lies in [floor((p - 1) fr / (R - 1)),
// floor((p + 1) fr / (R - 1))] (integer division: exact); kMargin cells more
// on each side take a cell that the host's rounding put one over.
__device__ __forceinline__ void cell_span(int p, int R, int fr, int& lo, int& hi) {
  if (R < 2) {
    lo = 0;
    hi = fr - 1;
    return;
  }
  lo = p >= 1 ? static_cast<int>((long long)(p - 1) * fr / (R - 1)) - kMargin : 0;
  hi = static_cast<int>((long long)(p + 1) * fr / (R - 1)) + kMargin;
  lo = max(lo, 0);
  hi = min(hi, fr - 1);
}

// The weight with which a row's sample reads pixel (px, py): the sum of its
// corners' weights there, in grid_sample_2d_adjoint's corner order (two
// corners meet only on the last pixel, where the +1 one weighs 0).
// T = bf16: each corner's weight cut to bf16 (K4's bf16 sample,
// bilinear.cuh cut_weights).
template <typename T>
__device__ __forceinline__ float corner_weight(const Corner& c, int px, int py) {
  const int x1 = c.x0 + c.dx, y1 = c.y0 + c.dy;
  const float ax = 1.0f - c.wx, ay = 1.0f - c.wy;
  float w = 0.0f;
  if (c.y0 == py) {
    if (c.x0 == px) w += round_as<T>(ax * ay);
    if (x1 == px) w += round_as<T>(c.wx * ay);
  }
  if (y1 == py) {
    if (c.x0 == px) w += round_as<T>(ax * c.wy);
    if (x1 == px) w += round_as<T>(c.wx * c.wy);
  }
  return w;
}

// The plan of the d_plane pass (tile_plan.d_plane_plan, which the wrapper
// checks against t2h_level_d_plane_plan): vec features a 16-byte lane; tpp
// threads a pixel and `groups` lanes a thread (lane k * tpp + g for thread
// g of its pixel; at most 32 f32 sums a thread), so fc = tpp x groups x vec
// features a block; the block's tx x ty pixels (256 / tpp of them), the
// tiles along x and y, the feature chunks, and the rows of a line batch
// (kDPlaneLines bytes of d_s lines in shared memory). By level: where a
// pixel spans one finest cell (R = fr) a thread takes all the lanes it can
// (up to 256 pixels a block); where it spans rho = fr / R of them along
// each axis, tpp is at least 2 rho (up to 16: 16 pixels a block), so that
// a block's list of rows stays short and its walk shares each row's line
// among fewer pixels. The walk takes kDPlaneStep cells a step
// (kDPlaneCells a thread) and as many rows an entry batch.
constexpr int kDPlaneThreads = 256;
constexpr int kDPlaneCells = 2;
constexpr int kDPlaneStep = kDPlaneThreads * kDPlaneCells;
constexpr int kDPlaneLines = 24576;  // a buffer of two
constexpr int kDPlaneSums = 32;  // f32 sums a thread: groups x vec
constexpr int kNoCorner = 0x7fff7fff;  // a padding row's corner: touches no pixel
constexpr int kWalk = 4;  // entries a thread weighs before it adds their terms

struct DPlanePlan {
  int vec, fc, tpp, groups, tx, ty, tiles_x, tiles_y, chunks, lines;
};

inline DPlanePlan d_plane_plan(int R, int F, int fr, int elem) {
  DPlanePlan p;
  p.vec = 16 / elem;
  const int lanes = (F + p.vec - 1) / p.vec;
  const int gmax = kDPlaneSums / p.vec;
  const int rho = std::max(1, fr / std::max(R, 1));
  const int level = rho <= 1 ? 1 : std::min(16, 2 * rho);
  p.tpp = std::min({lanes, 16, std::max(level, (lanes + gmax - 1) / gmax)});
  p.groups = std::min(gmax, (lanes + p.tpp - 1) / p.tpp);
  p.fc = p.tpp * p.groups * p.vec;
  const int pixels = kDPlaneThreads / p.tpp;
  p.tx = pixels >= 128 ? 16 : pixels >= 32 ? 8 : 4;
  p.ty = pixels / p.tx;
  p.tiles_x = (R + p.tx - 1) / p.tx;
  p.tiles_y = (R + p.ty - 1) / p.ty;
  p.chunks = (F + p.fc - 1) / p.fc;
  p.lines = std::min(kDPlaneStep, kDPlaneLines / (p.fc * elem));
  return p;
}

// The dynamic shared memory of d_plane_tiles: the step's cells' prefix sums
// and first rows, the entry batch's rows and entries (cell, corner x0 | y0
// << 16, weights: 16 bytes), and the line batch's d_s lines.
constexpr size_t kDPlaneSmem = (size_t)kDPlaneStep * (4 * 3 + 16) + 2 * kDPlaneLines;

// VEC values (16 bytes) stored to p: store_vec's, or 8 bf16 values.
template <int VEC, typename T>
__device__ __forceinline__ void store_line(T* p, const float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    static_assert(kIsBf16<T>, "eight values of a 16-byte line are bf16");
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    store_vec<VEC>(p, r);
  }
}

// VEC values of T at a 16-byte aligned shared address, as floats.
template <int VEC, typename T>
__device__ __forceinline__ void load_line16(const T* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
}

// A block a (tile of tx x ty pixels, chunk of fc features) of one batch
// entry (blockIdx.z); tpp threads a pixel. The block walks the finest cells
// under the union of its pixels' rectangles (from the first pixel's
// cell_span lower bound to the last's upper one, along each axis) in
// row-major order, kDPlaneStep cells a step: a thread loads two cells' row
// ranges, a block scan places each cell's rows in one list (cell order,
// then row order), and the list is taken kDPlaneStep rows an entry batch: a
// thread places two rows, their cells and corners (computed once, from xy;
// a padding row gets a corner that touches no pixel); then `lines` rows at
// a time the block copies their d_s lines into shared memory (16-byte
// cp.async, zero on padding rows and past F; two buffers, the next rows'
// copies in flight while these are walked) and each thread adds, in list
// order, w * d_s of the rows in its pixel's own rectangle of cells whose
// corner weight w at the pixel (corner_weight) is not 0, by fmaf into f32
// from 0, for its lanes: from the first entry in the pixel's rows of cells
// (a binary search), kWalk entries at a time, to the first past them.
// 62 KB of shared memory and 80 registers a thread: three blocks an SM, so
// that other blocks' steps cover each one's chain of dependent loads (row
// ranges, then rows' masks and coordinates, then lines). Row-major order over the tile's rectangle
// restricted to a pixel's rectangle is row-major order over the pixel's
// rectangle, so each pixel's sum takes the same terms in the same order as a
// walk of its own rectangle (the warp-a-pixel kernel this replaced): the
// same bits. Each pixel's chunk is stored once, rounded to TP. Types as the
// entry points below: TS = bf16 d_s in bf16 (the cotangent of a bf16
// sample, whose weights were cut: K4's, K9's), the weights cut the same
// way, the sum in f32, each pixel rounded to TP once (JAX rounds each
// tile's halo window, then folds the windows in bf16: windows_to_plane,
// level_bwd_kernel.py:403); TS = float and TP = bf16: the f32 cotangent of
// a bf16 plane's f32 sample (grid_sample_2d promotes it, JAX
// ops/sampling.py:28-46), the weights uncut, each pixel's f32 sum rounded
// to bf16 once, as JAX's vjp rounds its f32 d_plane to the plane's dtype.
// kVec: F * sizeof(TS) a multiple of 16 and ds, d_plane 16-byte aligned;
// otherwise the lines are copied and stored a value at a time.
template <typename TS, typename TP, bool kVec>
__global__ void __launch_bounds__(kDPlaneThreads, 3)
d_plane_tiles(const TS* __restrict__ ds, const float* __restrict__ xy,
              const uint8_t* __restrict__ mask, const int* __restrict__ start,
              const int* __restrict__ end, TP* __restrict__ d_plane, int N, int R, int F,
              int fr, DPlanePlan p) {
  constexpr int VEC = 16 / sizeof(TS);
  constexpr int kT = kDPlaneThreads;
  extern __shared__ float4 dplane_smem[];
  int* s_incl = reinterpret_cast<int*>(dplane_smem);  // the step's cells: inclusive row sums
  int* s_first = s_incl + kDPlaneStep;                  // and first rows
  int* s_row = s_first + kDPlaneStep;                   // the entry batch's rows
  // and their entries: cell (cy << 16) | cx, corner x0 | y0 << 16, wx, wy
  int4* s_ent = reinterpret_cast<int4*>(s_row + kDPlaneStep);
  TS* s_ds = reinterpret_cast<TS*>(s_ent + kDPlaneStep);  // two line batches: lines x fc
  __shared__ int s_warp[kT / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int tyi = blockIdx.x / p.tiles_x, txi = blockIdx.x - tyi * p.tiles_x;
  const int px0 = txi * p.tx, py0 = tyi * p.ty;
  int clx, chx, cly, chy, unused;
  cell_span(px0, R, fr, clx, unused);
  cell_span(min(px0 + p.tx, R) - 1, R, fr, unused, chx);
  cell_span(py0, R, fr, cly, unused);
  cell_span(min(py0 + p.ty, R) - 1, R, fr, unused, chy);
  const int span_x = chx - clx + 1;
  const int ncells = span_x * (chy - cly + 1);
  // this thread's pixel, its lanes, and its pixel's rectangle of cells
  const int pid = tid / p.tpp, g = tid - pid * p.tpp;
  const int px = px0 + pid % p.tx, py = py0 + pid / p.tx;
  const bool active = pid < p.tx * p.ty && px < R && py < R;
  int lox = 0, hix = -1, loy = 0, hiy = -1;
  if (active) {
    cell_span(px, R, fr, lox, hix);
    cell_span(py, R, fr, loy, hiy);
  }
  const int f0 = chunk * p.fc;
  const long long base = b * N;
  const long long cell0 = b * fr * fr;

  constexpr int kG = kDPlaneSums / VEC;  // the most lanes a thread
  float acc[kG][VEC] = {};
  for (int c0 = 0; c0 < ncells; c0 += kDPlaneStep) {
    int st[kDPlaneCells], n[kDPlaneCells], sum = 0;
#pragma unroll
    for (int i = 0; i < kDPlaneCells; ++i) {
      const int k = c0 + kDPlaneCells * tid + i;
      st[i] = 0;
      n[i] = 0;
      if (k < ncells) {
        const int ky = k / span_x;
        const long long at = cell0 + (long long)(cly + ky) * fr + clx + (k - ky * span_x);
        st[i] = start[at];
        n[i] = end[at] - st[i];
      }
      sum += n[i];
    }
    int incl = sum;  // the block's inclusive prefix sum of the threads' row counts
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();  // (also: the step before is done with s_incl and s_first)
    int run = incl - sum, total = 0;
#pragma unroll
    for (int w = 0; w < kT / 32; ++w) {
      run += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
#pragma unroll
    for (int i = 0; i < kDPlaneCells; ++i) {
      run += n[i];
      s_incl[kDPlaneCells * tid + i] = run;
      s_first[kDPlaneCells * tid + i] = st[i];
    }
    __syncthreads();
    for (int e0 = 0; e0 < total; e0 += kDPlaneStep) {
      const int ne = min(kDPlaneStep, total - e0);
      // this thread's entries i * kT + tid: their rows and cells from the
      // scan, then their masks and coordinates, all loaded before any is used
      int row[kDPlaneCells], cxy[kDPlaneCells];
      uint8_t mk[kDPlaneCells];
      float u[kDPlaneCells], v[kDPlaneCells];
#pragma unroll
      for (int i = 0; i < kDPlaneCells; ++i) {
        const int e = i * kT + tid;
        row[i] = -1;
        if (e >= ne) continue;
        const int tt = e0 + e;
        int j = 0;  // the step's cell whose rows hold list entry tt: the first with incl > tt
#pragma unroll
        for (int s = kDPlaneStep / 2; s > 0; s >>= 1)
          if (s_incl[j + s - 1] <= tt) j += s;
        row[i] = s_first[j] + tt - (j > 0 ? s_incl[j - 1] : 0);
        const int kc = c0 + j, ky = kc / span_x;
        s_row[e] = row[i];
        cxy[i] = ((cly + ky) << 16) | (clx + kc - ky * span_x);
      }
#pragma unroll
      for (int i = 0; i < kDPlaneCells; ++i) {
        if (row[i] < 0) continue;
        const long long q = base + row[i];
        mk[i] = mask[q];
        u[i] = xy[2 * q];
        v[i] = xy[2 * q + 1];
      }
#pragma unroll
      for (int i = 0; i < kDPlaneCells; ++i) {
        if (row[i] < 0) continue;
        const int e = i * kT + tid;
        int c = kNoCorner;
        float wx = 0.0f, wy = 0.0f;
        if (mk[i] != 0) {
          const Corner cr = bilinear_corner(u[i], v[i], R);
          c = cr.x0 | (cr.y0 << 16);
          wx = cr.wx;
          wy = cr.wy;
        }
        s_ent[e] = make_int4(cxy[i], c, __float_as_int(wx), __float_as_int(wy));
      }
      __syncthreads();
      // the batch's d_s lines, `lines` rows at a time into two buffers in
      // turn: the next rows' copies fly while these rows are walked
      auto copy_lines = [&](int l0) {
        const int nl = min(p.lines, ne - l0);
        TS* dst = s_ds + ((l0 / p.lines) & 1) * p.lines * p.fc;
        if constexpr (kVec) {
          const int parts = p.fc / VEC;
          for (int q = tid; q < nl * parts; q += kT) {
            const int e = q / parts, f = (q - e * parts) * VEC;
            const bool ok = s_ent[l0 + e].y != kNoCorner && f0 + f < F;
            cp_async16(dst + e * p.fc + f, ok ? ds + (base + s_row[l0 + e]) * F + f0 + f : ds,
                       ok ? 16 : 0);
          }
        } else {
          for (int q = tid; q < nl * p.fc; q += kT) {
            const int e = q / p.fc, f = q - e * p.fc;
            const bool ok = s_ent[l0 + e].y != kNoCorner && f0 + f < F;
            dst[e * p.fc + f] = ok ? ds[(base + s_row[l0 + e]) * F + f0 + f] : from_f32<TS>(0.0f);
          }
        }
        cp_async_commit();  // (an empty group on the value-at-a-time path)
      };
      copy_lines(0);
      for (int l0 = 0; l0 < ne; l0 += p.lines) {
        const int nl = min(p.lines, ne - l0);
        const TS* lines = s_ds + ((l0 / p.lines) & 1) * p.lines * p.fc;
        if (l0 + p.lines < ne) {
          copy_lines(l0 + p.lines);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          // the list runs in row-major cell order: from the first entry in
          // the pixel's rows of cells, kWalk entries at a time (their
          // weights first, then their terms in order), to the first past them
          int e0w = 0, hi = nl;
          while (e0w < hi) {
            const int mid = (e0w + hi) >> 1;
            if ((s_ent[l0 + mid].x >> 16) < loy) e0w = mid + 1; else hi = mid;
          }
          for (int e = e0w; e < nl; e += kWalk) {
            int4 en[kWalk];
            float w[kWalk];
#pragma unroll
            for (int u = 0; u < kWalk; ++u)
              en[u] = e + u < nl ? s_ent[l0 + e + u] : make_int4(0x7fffffff, kNoCorner, 0, 0);
#pragma unroll
            for (int u = 0; u < kWalk; ++u) {
              const int cy = en[u].x >> 16, cx = en[u].x & 0xffff;
              w[u] = 0.0f;
              if (cy <= hiy && cx >= lox && cx <= hix) {
                Corner cr;
                cr.x0 = en[u].y & 0xffff;
                cr.y0 = en[u].y >> 16;
                cr.dx = cr.x0 + 1 < R ? 1 : 0;  // bilinear_corner's
                cr.dy = cr.y0 + 1 < R ? 1 : 0;
                cr.wx = __int_as_float(en[u].z);
                cr.wy = __int_as_float(en[u].w);
                w[u] = corner_weight<TS>(cr, px, py);
              }
            }
#pragma unroll
            for (int u = 0; u < kWalk; ++u) {
              if (w[u] == 0.0f) continue;
#pragma unroll
              for (int k = 0; k < kG; ++k) {
                if (k >= p.groups) break;
                float v[VEC];
                load_line16<VEC>(lines + (e + u) * p.fc + (k * p.tpp + g) * VEC, v);
#pragma unroll
                for (int i = 0; i < VEC; ++i) acc[k][i] = fmaf(w[u], v[i], acc[k][i]);
              }
            }
            if ((en[kWalk - 1].x >> 16) > hiy) break;
          }
        }
        __syncthreads();  // these lines are read before their buffer takes others
      }
    }
  }
  if (!active) return;
  TP* out = d_plane + ((b * R + py) * R + px) * (long long)F;
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    if (k >= p.groups) break;
    const int f = f0 + (k * p.tpp + g) * VEC;
    if (kVec && f + VEC <= F) {
      store_line<VEC>(out + f, acc[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (f + i < F) out[f + i] = from_f32<TP>(acc[k][i]);
    }
  }
}

// The entry points' launches, for either element type (below).
template <typename T>
int level_bwd_rows(const T* plane, const float* xy, const int* cells, const uint8_t* mask,
                   const int* counts, const T* g_plane, const T* g_c, const T* w_in,
                   const T* b_in, const T* w_out_t, const T* w_c_t, const T* w_in_t,
                   T* d_clast, T* s_buf, T* h_buf, T* do_buf, T* dh_buf, T* ds_buf, int B,
                   int N, int R, int F, int Fl, int shift, cudaStream_t stream) {
  if (F > 512) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * N == 0) return static_cast<int>(cudaGetLastError());
  const int fp = F <= 32 ? 32 : F <= 64 ? 64 : F <= 128 ? 128 : F <= 256 ? 256 : 512;
  cudaError_t err;
#define T2H_ROWS(FP)                                                                        \
  case FP:                                                                                  \
    err = launch_rows<T, FP>(plane, xy, cells, mask, counts, g_plane, g_c, w_in, b_in,       \
                             w_out_t, w_c_t, w_in_t, d_clast, s_buf, h_buf, do_buf, dh_buf,  \
                             ds_buf, B, N, R, F, Fl, shift, stream);                         \
    break;
  switch (fp) {
    T2H_ROWS(32)
    T2H_ROWS(64)
    T2H_ROWS(128)
    T2H_ROWS(256)
    default:
    T2H_ROWS(512)
  }
#undef T2H_ROWS
  return static_cast<int>(err);
}

template <typename TS, typename TP>
int level_d_plane(const TS* ds, const float* xy, const int* cells, const uint8_t* mask,
                  int* offs, TP* d_plane, int B, int N, int R, int F, int fr,
                  cudaStream_t stream) {
  if (R < 1 || fr < R || (long long)fr * fr >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ncell = (long long)B * fr * fr;
  if ((long long)B * R * R * F == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(offs, 0, 2 * ncell * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0)
    cell_rows<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
        cells, offs, offs + ncell, N, fr);
  const DPlanePlan p = d_plane_plan(R, F, fr, sizeof(TS));
  if ((long long)p.tiles_x * p.tiles_y >= (1LL << 31) || p.chunks > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.tiles_x * p.tiles_y, p.chunks, B);
  const bool vec = (F * sizeof(TS)) % 16 == 0 && aligned16(ds) && aligned16(d_plane);
  auto kernel = vec ? d_plane_tiles<TS, TP, true> : d_plane_tiles<TS, TP, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDPlaneSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (size_t)kDPlaneStep * (4 * 3 + 16) + 2 * (size_t)p.lines * p.fc * sizeof(TS);
  kernel<<<grid, kDPlaneThreads, smem, stream>>>(ds, xy, mask, offs, offs + ncell, d_plane, N,
                                                 R, F, fr, p);
  return static_cast<int>(cudaGetLastError());
}

// The side of a reduction's output tile along a gradient side of n: 128, or
// 64 where n is 64 or less.
inline int reduce_tile(int n) { return n > 64 ? 128 : 64; }

int level_bwd_reduce(const float* A, const float* Bm, int M, int Ka, int Nb, int splits,
                     float* part, float* dw, float* db, cudaStream_t stream) {
  const int Kout = db != nullptr ? Ka + 1 : Ka;
  const bool wide_k = reduce_tile(Ka) == 128, wide_n = reduce_tile(Nb) == 128;
  const cudaError_t err =
      wide_k ? (wide_n ? launch_atb<128, 128>(A, Bm, M, Ka, Nb, Kout, splits, part, stream)
                       : launch_atb<128, 64>(A, Bm, M, Ka, Nb, Kout, splits, part, stream))
             : (wide_n ? launch_atb<64, 128>(A, Bm, M, Ka, Nb, Kout, splits, part, stream)
                       : launch_atb<64, 64>(A, Bm, M, Ka, Nb, Kout, splits, part, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits<<<grid_for((long long)Kout * Nb), kThreads, 0, stream>>>(part, splits, Ka,
                                                                         Kout, Nb, dw, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// Phase 1. Inputs as K4's (plane (B,R,R,F) NHWC, c_last (B,N,Fl), xy (B,N,2),
// cells (B,N) finest Morton ids, mask (B,N) u8) plus K4's counts (B,R,R) i32
// and the cotangents g_plane (B,R,R,F), g_c (B,N,F). Weights row-major: w_in
// (F,2F), b_in (2F), and the transposes w_out_t (F,2F), w_c_t (F,Fl), w_in_t
// (2F,F). Outputs: d_clast (B,N,Fl) and the rows: s_buf (B*N,F), h_buf
// (B*N,2F), do_buf (B*N,F), dh_buf (B*N,2F) for phase 2, ds_buf (B*N,F) (d_s)
// for phase 3. F <= 512; any Fl.
int t2h_fused_level_bwd(const float* plane, const float* xy, const int* cells,
                        const uint8_t* mask, const int* counts, const float* g_plane,
                        const float* g_c, const float* w_in, const float* b_in,
                        const float* w_out_t, const float* w_c_t, const float* w_in_t,
                        float* d_clast, float* s_buf, float* h_buf, float* do_buf,
                        float* dh_buf, float* ds_buf, int B, int N, int R, int F, int Fl,
                        int shift, cudaStream_t stream) {
  return level_bwd_rows(plane, xy, cells, mask, counts, g_plane, g_c, w_in, b_in, w_out_t,
                        w_c_t, w_in_t, d_clast, s_buf, h_buf, do_buf, dh_buf, ds_buf, B, N, R,
                        F, Fl, shift, stream);
}

// Phase 3. ds (B*N,F) the rows' d_s, xy (B,N,2), cells (B,N) finest Morton
// ids at fr (each finest cell's rows contiguous, pads out of range), mask
// (B,N) u8; offs: 2 * B * fr * fr ints of scratch -> d_plane (B,R,R,F), each
// pixel written once. A row's cell must lie within kMargin cells (each axis)
// of trunc(u * fr), as the host's layout makes it. Three launches: clear the
// offsets, mark, gather.
int t2h_level_d_plane(const float* ds, const float* xy, const int* cells, const uint8_t* mask,
                      int* offs, float* d_plane, int B, int N, int R, int F, int fr,
                      cudaStream_t stream) {
  return level_d_plane(ds, xy, cells, mask, offs, d_plane, B, N, R, F, fr, stream);
}

// The same on bf16 ds and d_plane: the weights cut to bf16, each pixel's
// f32 sum rounded once.
int t2h_level_d_plane_bf16(const bf16* ds, const float* xy, const int* cells,
                           const uint8_t* mask, int* offs, bf16* d_plane, int B, int N, int R,
                           int F, int fr, cudaStream_t stream) {
  return level_d_plane(ds, xy, cells, mask, offs, d_plane, B, N, R, F, fr, stream);
}

// The same on f32 ds into a bf16 d_plane: the weights uncut, each pixel's
// f32 sum rounded to bf16 once (the backward of the f32 sample of a bf16
// plane on the sorted layouts without K9: ops/fused.sorted_sample).
int t2h_level_d_plane_wide_bf16(const float* ds, const float* xy, const int* cells,
                                const uint8_t* mask, int* offs, bf16* d_plane, int B, int N,
                                int R, int F, int fr, cudaStream_t stream) {
  return level_d_plane(ds, xy, cells, mask, offs, d_plane, B, N, R, F, fr, stream);
}

// The d_plane pass's plan at (R, F, fr) for d_s elements of `elem` bytes:
// the integers of tile_plan.d_plane_plan in the order of
// tile_plan.D_PLANE_PLAN_KEYS -> out[13]. Returns 0.
int t2h_level_d_plane_plan(int R, int F, int fr, int elem, int* out) {
  const DPlanePlan p = d_plane_plan(R, F, fr, elem);
  const int v[] = {p.vec,     p.fc,      p.tpp,    p.groups,       p.tx,
                   p.ty,      p.tiles_x, p.tiles_y, p.chunks,      kDPlaneThreads,
                   kDPlaneStep, kDPlaneStep, p.lines};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// Output tiles of a (Ka x Nb) weight gradient; the wrapper sizes its row
// splits by them. Returns the count, not an error code.
int t2h_level_bwd_reduce_tiles(int Ka, int Nb) {
  const int tk = reduce_tile(Ka), tn = reduce_tile(Nb);
  return ((Ka + tk - 1) / tk) * ((Nb + tn - 1) / tn);
}

// Phase 2, one weight gradient: A (M,Ka), Bm (M,Nb) -> dw = A^T Bm (Ka,Nb)
// and, when db is not null, db = colsum(Bm) (Nb). Output tiles of
// reduce_tile(Ka) x reduce_tile(Nb), `splits` row splits; part: splits *
// (Ka+1) * Nb floats of scratch.
int t2h_level_bwd_reduce(const float* A, const float* Bm, int M, int Ka, int Nb,
                         int splits, float* part, float* dw, float* db,
                         cudaStream_t stream) {
  return level_bwd_reduce(A, Bm, M, Ka, Nb, splits, part, dw, db, stream);
}

}  // extern "C"
