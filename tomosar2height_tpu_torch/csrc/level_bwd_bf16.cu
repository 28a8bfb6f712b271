// K5's row pass in bf16: the first of K5's three phases (level_bwd.cu) on
// bf16 plane, cotangents, weights and scratch rows (xy f32, counts i32), the
// Hopper version of the per-row math of _level_bwd_kernel in
// tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:68 under its bf16 rule
// (:206-256). Per valid row, as K4 in bf16 (level_bf16.cu) recomputes it:
// s = the bilinear sample (cut weights, one rounding), pre = bf16(bf16(s
// W_in) + b_in), h = relu(pre), the gate [pre > 0]; then d_o = bf16(g_c +
// bf16(g_plane[cell] / max(count, 1))) (0 on padding rows), d_h =
// bf16(d_o W_out^T) * gate, d_s = bf16(d_h W_in^T), d_c_last = bf16(d_o
// W_c^T), each product summed in f32 and rounded once. Outputs: d_c_last and
// the scratch rows s, h, d_o, d_h (for the weight sums, reduce_bf16.cu) and
// d_s (for the d_plane pass), each element written once.
//
// Bound on the H100: 6 F^2 + F Fl MACs a row (the flagship's eight levels
// 0.6 ms at 989 TFLOP/s) against 7 F + Fl bf16 values written a row (1.4 ms
// at 3.35 TB/s). What a block streams instead: every block reads W_in,
// W_out and W_c from L2 (4 F^2 + F Fl values, 2.4 MB at F = 512, Fl = 256),
// so the L2 -> SM traffic is (rows / rows a block) x that, as in K4 in bf16,
// whose forward that stream bounds. The design (tile_plan.level_bwd_plan,
// mirrored by LevelBwdCfg), on warpgroup products fed by the TMA
// (wgmma_bf16.cuh):
//
// - Rows a block: 128 where F <= 256, two consumer warpgroups of 64 rows
//   each holding its rows' d_s (F / 2 f32 registers a thread), so each
//   weight byte read from L2 serves 128 rows (64 in the mma.sync kernel this
//   replaces). At F = 512 a block owns 64 rows, and its two warpgroups
//   split the hidden chunks and d_s's columns (256 each, 128 registers):
//   fused_level_bwd_wgmma_split, below.
// - s and d_o stay in shared memory for the whole block, in wgmma's
//   swizzled K-major layout (written by the threads, as K4 writes its
//   sample), as the A operands of every product.
// - F <= 256: W_in is read once a block: ring A holds one hidden chunk's W_in columns
//   (64 of them, all F rows, as boxes of 64 rows: the 128-byte swizzle that
//   TMA writes). The pre-activation reads it N-major (the transpose bit),
//   pre_c = s W_in[:, c]; d_s reads the same bytes K-major, d_s += d_h_c
//   W_in[:, c]^T. Once every warpgroup has read a chunk, thread 0 loads the
//   next chunk's boxes into it. The transposed copy of W_in is not read.
// - Ring B (an mbarrier ring of 8 KB stages, refilled by one thread of its
//   consumers) streams W_c^T's stages for d_c_last first (taken in column
//   chunks in d_s's registers before d_s accumulates, as K4 parks o1), then
//   per hidden chunk W_out^T's slices for d_o W_out^T[:, c]. Both read
//   N-major, 64-column boxes, zero past F, 2F and Fl.
// - Per hidden chunk c (64 columns): pre_c into 32 registers; h_c to
//   scratch, the gate as one bit a register (32 a thread); then d_o
//   W_out^T[:, c] into the same registers, gated and rounded to d_h_c, to
//   scratch and into a swizzled K-major tile in shared memory; then d_s +=
//   d_h_c W_in[:, c]^T from there.
// - Ordering: each output element written once, from registers or, for s
//   and d_o, from the threads that make them; no split-K, no atomics:
//   bit-equal run to run. Blocks whose rows are all padding write zeros and
//   skip the products and the loads. Each f32 sum runs over one k16 chain
//   per product: F (pre, d_h, d_c_last) or 2F (d_s) terms.
//
// Widths (FP: F rounded up to 64 .. 512, one instance each): F <= 256 in
// 128-row blocks, F = 512 in 64-row blocks, any Fl. F and Fl must be
// multiples of 8 and the tensors 16-byte aligned (the TMA's strides, the
// 16-byte loads and stores): the wrapper pads other widths with zero
// columns, which change no sum.
//
// Shared memory: s and d_o 2 x bm x FP bf16, the d_h tiles 16 KB, ring A
// FP / 64 boxes of 8 KB, ring B 4-8 stages of 8 KB: 89 KB at FP = 64 (two
// blocks an SM), 161 KB at 128, 217 KB at 256; at 512 one 64 KB tile (s,
// then d_o), 16 KB of d_h tiles and two rings of 64 KB: 209 KB.

#include <type_traits>

#include "bilinear.cuh"
#include "wgmma_bf16.cuh"

namespace t2h {

constexpr int kBwdSlice = 64;        // F rows a W_in / W_out^T box; hidden columns a chunk
constexpr int kBwdStageBytes = 8192;  // a ring slot
constexpr int kBwdThreads = 256;      // two consumer warpgroups

// F <= 256 (FP = 64, 128, 256): 128 rows a block, a warpgroup's own 64.
template <int FP>
struct LevelBwdCfg {
  static constexpr int kBM = 128;
  static constexpr int kSlots = FP / kBwdSlice;        // ring A: one chunk of W_in
  static constexpr int kNC = FP;                        // d_c_last columns a chunk
  static constexpr int kKC = kBwdStageBytes / (2 * kNC);  // W_c^T rows a stage
  static constexpr int kNS = FP;                        // d_s columns a warpgroup
  static constexpr int kStages = FP == 64 ? 4 : FP == 128 ? 8 : 5;  // ring B
  static constexpr int kMinBlocks = FP == 64 ? 2 : 1;
  static constexpr int kTileBytes = kBM * FP * 2;  // s, and d_o
  static constexpr int kHBytes = kBM * kBwdSlice * 2;  // the two d_h tiles
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)kTileBytes + kHBytes + (size_t)(kSlots + kStages) * kBwdStageBytes;
  static_assert(kSmem + 6144 <= 232448 / kMinBlocks, "shared memory");
  static_assert(kKC >= 16 && kKC % 16 == 0, "whole k16 steps a stage");
};

// F = 512: 64 rows a block; each warpgroup a ring of its own.
struct LevelBwdSplitCfg {
  static constexpr int FP = 512;
  static constexpr int kBM = 64;
  static constexpr int kNC = 256;  // d_c_last columns a chunk, 128 a warpgroup
  static constexpr int kKC = kBwdStageBytes / (2 * kNC / 2);  // W_c^T rows a stage
  static constexpr int kNS = 256;  // d_s columns a warpgroup
  static constexpr int kHalf = kNS / kBwdSlice;  // W_in boxes a warpgroup's d_s reads
  static constexpr int kStages = 8;  // a warpgroup's ring
  static constexpr int kTileBytes = kBM * FP * 2;  // s, then d_o
  static constexpr int kHBytes = 2 * kBM * kBwdSlice * 2;  // a pair of chunks' d_h tiles
  static constexpr size_t kSmem =
      1024 + (size_t)kTileBytes + kHBytes + (size_t)2 * kStages * kBwdStageBytes;
  static_assert(kSmem + 6144 <= 232448, "shared memory");
  static_assert(kKC % 16 == 0, "whole k16 steps a stage");
};

// The byte offset of element (r, k) of a K-major bf16 tile of `rows` rows in
// 64-column blocks of 128-byte rows, 128-byte swizzle (level_bf16.cu).
__device__ __forceinline__ int bwd_kmajor_at(int r, int k, int rows) {
  return (k >> 6) * rows * 128 + r * 128 + ((((k & 63) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2;
}

// The A descriptor of k16 step kq of such a tile, from row r0.
__device__ __forceinline__ uint64_t bwd_kmajor_desc(const uint8_t* tile, int rows, int r0,
                                                    int kq) {
  return gmma_desc(tile + (kq >> 2) * rows * 128 + r0 * 128 + (kq & 3) * 32, 16, 1024, 1);
}

// The B descriptor of k16 step kk of an N-major (transposed) 8 KB box of 64
// F-rows x 64 columns.
__device__ __forceinline__ uint64_t bwd_box_desc(const uint8_t* box, int kk) {
  return gmma_desc(box + kk * 2048, kBwdStageBytes, 1024, 1);
}

template <int K>
__device__ __forceinline__ void zero_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) d[i] = 0.0f;
  fence_acc(d);
}

// What a block knows of its rows (threads 0 .. kBM - 1, a row each).
template <int kBM>
struct BwdRows {
  int valid[kBM];
  int cell[kBM];  // row-major cell at this level, -1 if none
  float cnt[kBM];  // max(count, 1) of the row's cell
  Corner corner[kBM];
  int any;
};

// Fill `rows` for the block's rows i0 .. of batch entry b; returns (to
// every thread) whether any row is valid.
template <int kBM>
__device__ __forceinline__ bool bwd_rows(BwdRows<kBM>& rs, const float* __restrict__ xy,
                                         const int* __restrict__ cells,
                                         const uint8_t* __restrict__ mask,
                                         const int* __restrict__ counts, int b, int i0, int N,
                                         int R, int shift) {
  const int tid = threadIdx.x;
  const long long RR = (long long)R * R;
  if (tid == 0) rs.any = 0;
  __syncthreads();
  if (tid < kBM) {
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
        rs.any = 1;
      }
    }
    rs.valid[tid] = valid;
    rs.cell[tid] = cellr;
    rs.corner[tid] = corner;
    rs.cnt[tid] = cnt;
  }
  __syncthreads();
  return rs.any != 0;
}

// Every output and scratch row of a block whose rows are all padding: 0.
__device__ __forceinline__ void bwd_zero_rows(long long row_b, int rows, int F, int Fl,
                                              bf16* d_clast, bf16* s_buf, bf16* h_buf,
                                              bf16* do_buf, bf16* dh_buf, bf16* ds_buf) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const int H = 2 * F;
  for (int e = threadIdx.x; e < rows * H / 8; e += blockDim.x) {
    reinterpret_cast<uint4*>(h_buf + row_b * H)[e] = z;
    reinterpret_cast<uint4*>(dh_buf + row_b * H)[e] = z;
  }
  for (int e = threadIdx.x; e < rows * F / 8; e += blockDim.x) {
    reinterpret_cast<uint4*>(s_buf + row_b * F)[e] = z;
    reinterpret_cast<uint4*>(do_buf + row_b * F)[e] = z;
    reinterpret_cast<uint4*>(ds_buf + row_b * F)[e] = z;
  }
  for (int e = threadIdx.x; e < rows * Fl / 8; e += blockDim.x)
    reinterpret_cast<uint4*>(d_clast + row_b * Fl)[e] = z;
}

// The sample -> the K-major tile and s_buf (zeros past F and on padding
// rows in the tile; rows past N not stored): K4's bf16 sample
// (level_bf16.cu), kU tasks (a row and 8 channels) a thread at a time, their
// loads issued before any is used.
template <int kBM, int FP>
__device__ __forceinline__ void bwd_sample(const BwdRows<kBM>& rs, uint8_t* tile,
                                           const bf16* __restrict__ pl, bf16* s_buf,
                                           long long row_b, int rows, int R, int F) {
  constexpr int kChunks = FP / 8, kU = 4;
  static_assert(kBM * kChunks % (kU * kBwdThreads) == 0, "whole rounds of tasks");
  for (int e0 = threadIdx.x; e0 < kBM * kChunks; e0 += kU * kBwdThreads) {
    uint4 v[kU][4];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kBwdThreads, r = e / kChunks, k = 8 * (e - r * kChunks);
      ok[u] = k < F && r < rows && rs.valid[r];
      if (ok[u]) {
        const Corner cr = rs.corner[r];
        const long long o = ((long long)cr.y0 * R + cr.x0) * F + k;
        const long long ox = (long long)cr.dx * F, oy = (long long)cr.dy * R * F;
        v[u][0] = __ldg(reinterpret_cast<const uint4*>(pl + o));
        v[u][1] = __ldg(reinterpret_cast<const uint4*>(pl + o + ox));
        v[u][2] = __ldg(reinterpret_cast<const uint4*>(pl + o + oy));
        v[u][3] = __ldg(reinterpret_cast<const uint4*>(pl + o + oy + ox));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kBwdThreads, r = e / kChunks, k = 8 * (e - r * kChunks);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        float w[4];
        cut_weights(rs.corner[r], w);
        const bf16* p0 = reinterpret_cast<const bf16*>(&v[u][0]);
        const bf16* p1 = reinterpret_cast<const bf16*>(&v[u][1]);
        const bf16* p2 = reinterpret_cast<const bf16*>(&v[u][2]);
        const bf16* p3 = reinterpret_cast<const bf16*>(&v[u][3]);
        bf16* q = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int t = 0; t < 8; ++t) {  // bilinear_at's order, one rounding
          float s = w[0] * to_f32(p0[t]);
          s += w[1] * to_f32(p1[t]);
          s += w[2] * to_f32(p2[t]);
          s += w[3] * to_f32(p3[t]);
          q[t] = from_f32<bf16>(s);
        }
      }
      *reinterpret_cast<uint4*>(tile + bwd_kmajor_at(r, k, kBM)) = out;
      if (k < F && r < rows) *reinterpret_cast<uint4*>(s_buf + (row_b + r) * F + k) = out;
    }
  }
}

// d_o = bf16(g_c + bf16(g_plane[cell] / count)) on valid rows, else 0 (the
// quotient rounded, then the sum: level_bwd_kernel.py:228-243) -> the
// K-major tile and do_buf, as bwd_sample.
template <int kBM, int FP>
__device__ __forceinline__ void bwd_grad(const BwdRows<kBM>& rs, uint8_t* tile,
                                         const bf16* __restrict__ gp,
                                         const bf16* __restrict__ g_c, bf16* do_buf,
                                         long long row_b, int rows, int F) {
  constexpr int kChunks = FP / 8, kU = 4;
  for (int e0 = threadIdx.x; e0 < kBM * kChunks; e0 += kU * kBwdThreads) {
    uint4 gc[kU], gv[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kBwdThreads, r = e / kChunks, k = 8 * (e - r * kChunks);
      ok[u] = k < F && r < rows && rs.valid[r];
      if (ok[u]) {
        gc[u] = __ldg(reinterpret_cast<const uint4*>(g_c + (row_b + r) * F + k));
        if (rs.cell[r] >= 0)
          gv[u] = __ldg(reinterpret_cast<const uint4*>(gp + (long long)rs.cell[r] * F + k));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kBwdThreads, r = e / kChunks, k = 8 * (e - r * kChunks);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const bf16* pc = reinterpret_cast<const bf16*>(&gc[u]);
        const bf16* pg = reinterpret_cast<const bf16*>(&gv[u]);
        const bool has = rs.cell[r] >= 0;
        const float cnt = rs.cnt[r];
        bf16* q = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float x = to_f32(pc[t]);
          if (has) x += round_as<bf16>(to_f32(pg[t]) / cnt);
          q[t] = from_f32<bf16>(x);
        }
      }
      *reinterpret_cast<uint4*>(tile + bwd_kmajor_at(r, k, kBM)) = out;
      if (k < F && r < rows) *reinterpret_cast<uint4*>(do_buf + (row_b + r) * F + k) = out;
    }
  }
}

// pre = bf16(bf16(acc) + b_in) for hidden chunk c (0 past 2F): h = relu(pre)
// -> h_buf for the fragment rows r0 + rr (+8) below `rows`; returns the
// gate bits (bit 4j + i: fragment element (j, i) of pre > 0).
__device__ __forceinline__ uint32_t bwd_pre_epilogue(const float (&acc)[32],
                                                     const bf16* __restrict__ b_in,
                                                     bf16* h_buf, long long row_b, int r0,
                                                     int rr, int q2, int c, int rows, int H) {
  uint32_t gate = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = c * kBwdSlice + 8 * j + q2;
    const bool in = n < H;  // H % 16 == 0: n + 1 < H too
    const float bi0 = in ? to_f32(b_in[n]) : 0.0f;
    const float bi1 = in ? to_f32(b_in[n + 1]) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      const float p0 = in ? round_as<bf16>(round_as<bf16>(acc[e]) + bi0) : 0.0f;
      const float p1 = in ? round_as<bf16>(round_as<bf16>(acc[e + 1]) + bi1) : 0.0f;
      gate |= (p0 > 0.0f ? 1u : 0u) << e;
      gate |= (p1 > 0.0f ? 1u : 0u) << (e + 1);
      const int r = r0 + rr + 8 * h;
      if (in && r < rows)
        *reinterpret_cast<__nv_bfloat162*>(h_buf + (row_b + r) * H + n) =
            __floats2bfloat162_rn(fmaxf(p0, 0.0f), fmaxf(p1, 0.0f));
    }
  }
  return gate;
}

// d_h = bf16(gated acc) for hidden chunk c -> dh_buf (rows below `rows`)
// and the 64-row K-major tile (fragment rows rr, rr + 8).
__device__ __forceinline__ void bwd_dh_epilogue(const float (&acc)[32], uint32_t gate,
                                                uint8_t* tile, bf16* dh_buf, long long row_b,
                                                int r0, int rr, int q2, int c, int rows,
                                                int H) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = c * kBwdSlice + 8 * j + q2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      const __nv_bfloat162 d = __floats2bfloat162_rn((gate >> e) & 1u ? acc[e] : 0.0f,
                                                     (gate >> (e + 1)) & 1u ? acc[e + 1] : 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(tile + bwd_kmajor_at(rr + 8 * h, 8 * j + q2, 64)) = d;
      const int r = r0 + rr + 8 * h;
      if (n < H && r < rows)
        *reinterpret_cast<__nv_bfloat162*>(dh_buf + (row_b + r) * H + n) = d;
    }
  }
}

// A fragment of N columns (N / 2 values a thread) -> out (row stride ld),
// columns n0 .. below `cols`, fragment rows r0 + rr (+8) below `rows`.
template <int K>
__device__ __forceinline__ void bwd_store(const float (&acc)[K], int nvals, bf16* out,
                                          long long row_b, int ld, int r0, int rr, int q2,
                                          int n0, int cols, int rows) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    if (4 * q >= nvals) break;
    const int n = n0 + 8 * q + q2;
    if (n >= cols) continue;  // cols % 8 == 0: n + 1 < cols too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + rr + 8 * h;
      if (r < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (row_b + r) * ld + n) =
            __floats2bfloat162_rn(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
    }
  }
}

// F <= 256: each warpgroup its own 64 rows, all columns; ring A (W_in's
// chunk) and ring B (W_c^T's stages, then W_out^T's slices) refilled by
// thread 0.
template <int FP>
__global__ void __launch_bounds__(kBwdThreads, LevelBwdCfg<FP>::kMinBlocks)
fused_level_bwd_wgmma(const __grid_constant__ CUtensorMap map_wi,
                      const __grid_constant__ CUtensorMap map_wo,
                      const __grid_constant__ CUtensorMap map_wc, const bf16* __restrict__ plane,
                      const float* __restrict__ xy, const int* __restrict__ cells,
                      const uint8_t* __restrict__ mask, const int* __restrict__ counts,
                      const bf16* __restrict__ g_plane, const bf16* __restrict__ g_c,
                      const bf16* __restrict__ b_in, bf16* __restrict__ d_clast,
                      bf16* __restrict__ s_buf, bf16* __restrict__ h_buf,
                      bf16* __restrict__ do_buf, bf16* __restrict__ dh_buf,
                      bf16* __restrict__ ds_buf, int N, int R, int F, int Fl, int shift) {
  using C = LevelBwdCfg<FP>;
  constexpr int S = C::kStages;
  constexpr int kBM = C::kBM;
  constexpr int kSB = kBwdStageBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_a[C::kSlots], empty_a[C::kSlots], full_b[S], empty_b[S];
  __shared__ BwdRows<kBM> rs;
  uint8_t* s_tile = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* do_tile = s_tile + C::kTileBytes;
  uint8_t* h_tiles = do_tile + C::kTileBytes;
  uint8_t* ring_a = h_tiles + C::kHBytes;
  uint8_t* ring_b = ring_a + C::kSlots * kSB;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int rows = min(kBM, N - i0);
  const long long row_b = (long long)b * N + i0;
  const int H = 2 * F;
  const long long RR = (long long)R * R;

  if (tid == 0) {
    for (int v = 0; v < C::kSlots; ++v) {
      mbar_init(&full_a[v], 1);
      mbar_init(&empty_a[v], kBwdThreads);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], kBwdThreads);
    }
    mbar_init_fence();
  }
  if (!bwd_rows(rs, xy, cells, mask, counts, b, i0, N, R, shift)) {
    bwd_zero_rows(row_b, rows, F, Fl, d_clast, s_buf, h_buf, do_buf, dh_buf, ds_buf);
    return;
  }

  const int F16 = (F + 15) & ~15;
  const int nH = (H + kBwdSlice - 1) / kBwdSlice;   // hidden chunks
  const int nIn = (F + kBwdSlice - 1) / kBwdSlice;  // W_in boxes, W_out^T slices a chunk
  const int nKC = (F + C::kKC - 1) / C::kKC;        // W_c^T stages a column chunk
  const int nDC = (Fl + C::kNC - 1) / C::kNC;       // d_c_last column chunks
  const int TB0 = nDC * nKC;
  const int n_tiles_b = TB0 + nH * nIn;

  // Ring A: chunk c's W_in boxes, thread 0 loading box v once every thread
  // has released chunk c - 1's.
  auto issue_a = [&](int c, int v) {
    if (c > 0) mbar_wait(&empty_a[v], (c - 1) & 1);
    mbar_arrive_expect_tx(&full_a[v], kSB);
    tma_load_2d(ring_a + v * kSB, &map_wi, &full_a[v], c * kBwdSlice, v * kBwdSlice);
  };
  // Ring B, tile t: the W_c^T stages (column chunk j, rows v * kKC ..), then
  // per hidden chunk its W_out^T slices; a slot loaded again once every
  // thread has released the tile before in it.
  auto issue_b = [&](int t) {
    if (t >= n_tiles_b) return;
    const int s = t % S;
    if (t >= S) mbar_wait(&empty_b[s], ((t / S) & 1) ^ 1);
    uint8_t* st = ring_b + s * kSB;
    mbar_arrive_expect_tx(&full_b[s], kSB);
    if (t < TB0) {
      const int j = t / nKC, v = t - j * nKC;
#pragma unroll
      for (int i = 0; i < C::kNC / 64; ++i)
        tma_load_2d(st + i * C::kKC * 128, &map_wc, &full_b[s], j * C::kNC + 64 * i,
                    v * C::kKC);
    } else {
      const int u = t - TB0, c = u / nIn, v = u - c * nIn;
      tma_load_2d(st, &map_wo, &full_b[s], c * kBwdSlice, v * kBwdSlice);
    }
  };
  if (tid == 0) {
    for (int v = 0; v < nIn; ++v) issue_a(0, v);
    for (int t = 0; t < S; ++t) issue_b(t);  // in flight while s and d_o are made
  }

  bwd_sample<kBM, FP>(rs, s_tile, plane + (long long)b * RR * F, s_buf, row_b, rows, R, F);
  bwd_grad<kBM, FP>(rs, do_tile, g_plane + (long long)b * RR * F, g_c, do_buf, row_b, rows, F);
  fence_async_shared();  // s and d_o, written by threads, read by wgmma
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 64 * wg;  // this warpgroup's rows
  uint8_t* h_tile = h_tiles + wg * 8192;
  const int rr = 16 * warp + lane / 4;  // fragment rows rr, rr + 8 of the warpgroup
  const int q2 = 2 * (lane % 4);        // fragment column pairs 8j + q2

  // ring B's consumers: the tile counter and the tile whose products may be
  // in flight (level_bf16.cu's acquire / retire / drain)
  int it = 0, held = -1;
  auto acquire_b = [&]() {
    const int s = it % S;
    mbar_wait(&full_b[s], (it / S) & 1);
    wgmma_fence();
    return static_cast<const uint8_t*>(ring_b + s * kSB);
  };
  auto release_b = [&]() {
    if (held >= 0) {
      mbar_arrive(&empty_b[held % S]);
      if (tid == 0) issue_b(held + S);
    }
  };
  auto retire_b = [&]() {
    wgmma_commit();
    wgmma_wait<1>();
    release_b();
    held = it++;
  };
  auto drain_b = [&]() {
    wgmma_wait<0>();
    release_b();
    held = -1;
  };

  float ds[C::kNS / 2];  // d_c_last's column chunks, then d_s
  float hacc[32];        // pre_c, then d_o W_out^T[:, c]

  // --- d_c_last = d_o W_c^T, a column chunk at a time ----------------------------
  for (int j = 0; j < nDC; ++j) {
    zero_acc(ds);
    for (int v = 0; v < nKC; ++v) {
      const uint8_t* st = acquire_b();
      const int steps = min(C::kKC, F16 - v * C::kKC) / 16;
      for (int kk = 0; kk < steps; ++kk)
        wgmma_bf16<C::kNC, 0, 1>(ds, bwd_kmajor_desc(do_tile, kBM, r0, v * (C::kKC / 16) + kk),
                                 gmma_desc(st + kk * 2048, C::kKC * 128, 1024, 1));
      retire_b();
    }
    drain_b();
    fence_acc(ds);
    bwd_store(ds, C::kNC / 2, d_clast, row_b, Fl, r0, rr, q2, j * C::kNC, Fl, rows);
  }

  zero_acc(ds);
  for (int c = 0; c < nH; ++c) {
    // pre_c = s W_in[:, c * 64 ..+ 64]
    zero_acc(hacc);
    for (int v = 0; v < nIn; ++v) {
      mbar_wait(&full_a[v], c & 1);
      wgmma_fence();
      const int steps = min(kBwdSlice, F16 - v * kBwdSlice) / 16;
      for (int kk = 0; kk < steps; ++kk)
        wgmma_bf16<64, 0, 1>(hacc, bwd_kmajor_desc(s_tile, kBM, r0, 4 * v + kk),
                             bwd_box_desc(ring_a + v * kSB, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(hacc);
    const uint32_t gate = bwd_pre_epilogue(hacc, b_in, h_buf, row_b, r0, rr, q2, c, rows, H);
    // d_o W_out^T[:, c * 64 ..+ 64]
    zero_acc(hacc);
    for (int v = 0; v < nIn; ++v) {
      const uint8_t* st = acquire_b();
      const int steps = min(kBwdSlice, F16 - v * kBwdSlice) / 16;
      for (int kk = 0; kk < steps; ++kk)
        wgmma_bf16<64, 0, 1>(hacc, bwd_kmajor_desc(do_tile, kBM, r0, 4 * v + kk),
                             bwd_box_desc(st, kk));
      retire_b();
    }
    drain_b();
    fence_acc(hacc);
    // the d_h tile is free once every product of the chunk before has read it
    named_barrier(2 + wg, 128);
    bwd_dh_epilogue(hacc, gate, h_tile, dh_buf, row_b, r0, rr, q2, c, rows, H);
    fence_async_shared();
    named_barrier(2 + wg, 128);
    // d_s += d_h_c W_in[:, c * 64 ..+ 64]^T: ring A's boxes read K-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16<C::kNS, 0, 0>(ds, bwd_kmajor_desc(h_tile, 64, 0, kk),
                               gmma_desc(ring_a + kk * 32, 16, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(ds);
    for (int v = 0; v < nIn; ++v) mbar_arrive(&empty_a[v]);
    if (tid == 0 && c + 1 < nH)
      for (int v = 0; v < nIn; ++v) issue_a(c + 1, v);
  }
  bwd_store(ds, C::kNS / 2, ds_buf, row_b, F, r0, rr, q2, 0, F, rows);
}

// F = 512: 64 rows a block, in two phases, each warpgroup with a ring of its
// own (8 stages of 8 KB, refilled by its first thread; only it consumes it):
// A. the pre-activations: warpgroup w takes the hidden chunks c = w, w + 2,
//    ..: pre_c = s W_in[:, c] from its ring's W_in boxes, h_c to scratch, the
//    gate bits kept in a register a chunk (8 a thread);
// then d_o replaces s in the tile;
// B. d_c_last: each warpgroup 128 of a 256-column chunk; then the chunks in
//    pairs (2p, 2p + 1): warpgroup w takes d_h of chunk 2p + w (its gates,
//    W_out^T's slices) into the pair's tile w, and then both d_s terms of
//    the pair for its 256 columns of d_s, reading the W_in boxes of its rows
//    K-major (four a chunk, one k16 n64 product each of their k16 steps).
// W_in is read twice a block (phase A, and its halves in phase B): 3.3 MB a
// block, all through rings 64 KB deep a warpgroup, where the one-ring design
// held W_in's chunk resident and streamed the rest through 16 KB.
__global__ void __launch_bounds__(kBwdThreads, 1)
fused_level_bwd_wgmma_split(const __grid_constant__ CUtensorMap map_wi,
                            const __grid_constant__ CUtensorMap map_wo,
                            const __grid_constant__ CUtensorMap map_wc,
                            const bf16* __restrict__ plane, const float* __restrict__ xy,
                            const int* __restrict__ cells, const uint8_t* __restrict__ mask,
                            const int* __restrict__ counts, const bf16* __restrict__ g_plane,
                            const bf16* __restrict__ g_c, const bf16* __restrict__ b_in,
                            bf16* __restrict__ d_clast, bf16* __restrict__ s_buf,
                            bf16* __restrict__ h_buf, bf16* __restrict__ do_buf,
                            bf16* __restrict__ dh_buf, bf16* __restrict__ ds_buf, int N, int R,
                            int F, int Fl, int shift) {
  using C = LevelBwdSplitCfg;
  constexpr int S = C::kStages;
  constexpr int kBM = C::kBM;
  constexpr int kSB = kBwdStageBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][S], empty[2][S];
  __shared__ BwdRows<kBM> rs;
  uint8_t* tile = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* h_tiles = tile + C::kTileBytes;
  uint8_t* rings = h_tiles + C::kHBytes;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int rows = min(kBM, N - i0);
  const long long row_b = (long long)b * N + i0;
  const int H = 2 * F;
  const long long RR = (long long)R * R;

  if (tid == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[w][s], 1);
        mbar_init(&empty[w][s], 128);
      }
    mbar_init_fence();
  }
  if (!bwd_rows(rs, xy, cells, mask, counts, b, i0, N, R, shift)) {
    bwd_zero_rows(row_b, rows, F, Fl, d_clast, s_buf, h_buf, do_buf, dh_buf, ds_buf);
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int F16 = (F + 15) & ~15;
  const int nH = (H + kBwdSlice - 1) / kBwdSlice;   // hidden chunks
  const int nIn = (F + kBwdSlice - 1) / kBwdSlice;  // W_in boxes, W_out^T slices a chunk
  const int nKC = (F + C::kKC - 1) / C::kKC;        // W_c^T stages a column chunk
  const int nDC = (Fl + C::kNC - 1) / C::kNC;       // d_c_last column chunks
  const int nPairs = (nH + 1) / 2;
  // this warpgroup's share: its phase-A chunks, its W_in boxes in phase B
  const int nMine = (nH - wg + 1) / 2;
  const int v0 = C::kHalf * wg, nHalf = max(0, min(nIn, v0 + C::kHalf) - v0);
  const int TA = nMine * nIn;
  const int TB = TA + nDC * nKC;
  uint8_t* ring = rings + wg * S * kSB;

  // This warpgroup's tile t: phase A's W_in boxes (chunk wg + 2 (t / nIn),
  // box t % nIn), then W_c^T's stages (column chunk j: its 128 columns, rows
  // v * kKC ..), then per pair its chunk's W_out^T slices (if it has one)
  // and its W_in boxes of the pair's chunks.
  auto pair_tiles = [&](int p) {
    return (2 * p + wg < nH ? nIn : 0) + nHalf * (2 * p + 1 < nH ? 2 : 1);
  };
  const int n_tiles = TB + (nPairs - 1) * pair_tiles(0) + pair_tiles(nPairs - 1);
  auto issue = [&](int t) {
    if (t >= n_tiles) return;
    const int s = t % S;
    if (t >= S) mbar_wait(&empty[wg][s], ((t / S) & 1) ^ 1);
    uint8_t* st = ring + s * kSB;
    mbar_arrive_expect_tx(&full[wg][s], kSB);
    if (t < TA) {
      const int c = wg + 2 * (t / nIn), v = t % nIn;
      tma_load_2d(st, &map_wi, &full[wg][s], c * kBwdSlice, v * kBwdSlice);
    } else if (t < TB) {
      const int u = t - TA, j = u / nKC, v = u - j * nKC;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tma_load_2d(st + i * C::kKC * 128, &map_wc, &full[wg][s],
                    j * C::kNC + (C::kNC / 2) * wg + 64 * i, v * C::kKC);
    } else {
      const int u = t - TB, per = pair_tiles(0), p = u / per;
      int k = u - p * per;
      const int mine = 2 * p + wg < nH ? nIn : 0;
      if (k < mine) {
        tma_load_2d(st, &map_wo, &full[wg][s], (2 * p + wg) * kBwdSlice, k * kBwdSlice);
      } else {
        k -= mine;
        const int c = 2 * p + k / nHalf, v = v0 + k % nHalf;
        tma_load_2d(st, &map_wi, &full[wg][s], c * kBwdSlice, v * kBwdSlice);
      }
    }
  };
  if (tid % 128 == 0)
    for (int t = 0; t < S; ++t) issue(t);  // in flight while s is made

  int it = 0, held = -1;
  auto acquire = [&]() {
    const int s = it % S;
    mbar_wait(&full[wg][s], (it / S) & 1);
    wgmma_fence();
    return static_cast<const uint8_t*>(ring + s * kSB);
  };
  auto release = [&]() {
    if (held >= 0) {
      mbar_arrive(&empty[wg][held % S]);
      if (tid % 128 == 0) issue(held + S);
    }
  };
  auto retire = [&]() {
    wgmma_commit();
    wgmma_wait<1>();
    release();
    held = it++;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    release();
    held = -1;
  };

  bwd_sample<kBM, C::FP>(rs, tile, plane + (long long)b * RR * F, s_buf, row_b, rows, R, F);
  fence_async_shared();
  __syncthreads();

  const int rr = 16 * warp + lane / 4;  // fragment rows rr, rr + 8
  const int q2 = 2 * (lane % 4);        // fragment column pairs 8j + q2
  float hacc[32];
  uint32_t gates[8];  // phase A's gate bits of this warpgroup's chunks (8 at most)

  // --- A: pre_c for c = wg, wg + 2, .. --------------------------------------------
  for (int m = 0; m < nMine; ++m) {
    const int c = wg + 2 * m;
    zero_acc(hacc);
    for (int v = 0; v < nIn; ++v) {
      const uint8_t* st = acquire();
      const int steps = min(kBwdSlice, F16 - v * kBwdSlice) / 16;
      for (int kk = 0; kk < steps; ++kk)
        wgmma_bf16<64, 0, 1>(hacc, bwd_kmajor_desc(tile, kBM, 0, 4 * v + kk),
                             bwd_box_desc(st, kk));
      retire();
    }
    drain();
    fence_acc(hacc);
    gates[m] = bwd_pre_epilogue(hacc, b_in, h_buf, row_b, 0, rr, q2, c, rows, H);
  }
  // every pre-activation has read s: d_o takes its place
  __syncthreads();
  bwd_grad<kBM, C::FP>(rs, tile, g_plane + (long long)b * RR * F, g_c, do_buf, row_b, rows, F);
  fence_async_shared();
  __syncthreads();

  // --- B: d_c_last, 128 columns of each 256-column chunk a warpgroup ---------------
  float ds[C::kNS / 2];  // d_c_last's column chunks (the first 64), then d_s
  for (int j = 0; j < nDC; ++j) {
    zero_acc(ds);
    for (int v = 0; v < nKC; ++v) {
      const uint8_t* st = acquire();
      const int steps = min(C::kKC, F16 - v * C::kKC) / 16;
      for (int kk = 0; kk < steps; ++kk)
        wgmma_m64n128_at<0, 0, 1>(ds, bwd_kmajor_desc(tile, kBM, 0, v * (C::kKC / 16) + kk),
                                  gmma_desc(st + kk * 2048, C::kKC * 128, 1024, 1));
      retire();
    }
    drain();
    fence_acc(ds);
    bwd_store(ds, 64, d_clast, row_b, Fl, 0, rr, q2, j * C::kNC + (C::kNC / 2) * wg, Fl, rows);
  }

  zero_acc(ds);
  for (int p = 0; p < nPairs; ++p) {
    const int c = 2 * p + wg;
    // the pair's tiles are free once both warpgroups' d_s of the pair before
    // have read them (drained below)
    named_barrier(1, kBwdThreads);
    if (c < nH) {
      zero_acc(hacc);
      for (int v = 0; v < nIn; ++v) {
        const uint8_t* st = acquire();
        const int steps = min(kBwdSlice, F16 - v * kBwdSlice) / 16;
        for (int kk = 0; kk < steps; ++kk)
          wgmma_bf16<64, 0, 1>(hacc, bwd_kmajor_desc(tile, kBM, 0, 4 * v + kk),
                               bwd_box_desc(st, kk));
        retire();
      }
      drain();
      fence_acc(hacc);
      bwd_dh_epilogue(hacc, gates[p], h_tiles + wg * 8192, dh_buf, row_b, 0, rr, q2, c, rows,
                      H);
      fence_async_shared();
    }
    named_barrier(1, kBwdThreads);
    // d_s[:, 256 wg ..] += d_h_cc W_in[256 wg .., cc]^T for the pair's chunks
    for (int cc = 2 * p; cc < min(2 * p + 2, nH); ++cc) {
      const uint8_t* dh = h_tiles + (cc - 2 * p) * 8192;
#pragma unroll
      for (int u = 0; u < C::kHalf; ++u) {
        if (u >= nHalf) break;
        const uint8_t* st = acquire();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = bwd_kmajor_desc(dh, 64, 0, kk);
          const uint64_t db = gmma_desc(st + kk * 32, 16, 1024, 1);
          if (u == 0) wgmma_m64n64_at<0, 0, 0>(ds, da, db);
          if (u == 1) wgmma_m64n64_at<32, 0, 0>(ds, da, db);
          if (u == 2) wgmma_m64n64_at<64, 0, 0>(ds, da, db);
          if (u == 3) wgmma_m64n64_at<96, 0, 0>(ds, da, db);
        }
        retire();
      }
    }
    drain();
    fence_acc(ds);
  }
  bwd_store(ds, C::kNS / 2, ds_buf, row_b, F, 0, rr, q2, C::kNS * wg, F, rows);
}

inline cudaError_t bwd_tensor_maps(CUtensorMap* map_wi, CUtensorMap* map_wo, CUtensorMap* map_wc,
                            const bf16* w_in, const bf16* w_out_t, const bf16* w_c_t, int F,
                            int Fl, int kc) {
  const uint64_t f = F, fl = Fl;
  const uint32_t sl = kBwdSlice;
  // W_in and W_out^T (F, 2F): boxes of 64 hidden columns x 64 rows of F;
  // W_c^T (F, Fl): boxes of 64 columns x kc rows
  cudaError_t err = bf16_tensor_map<2>(map_wi, w_in, {2 * f, f}, {4 * f}, {sl, sl}, 128);
  if (err == cudaSuccess)
    err = bf16_tensor_map<2>(map_wo, w_out_t, {2 * f, f}, {4 * f}, {sl, sl}, 128);
  if (err == cudaSuccess)
    err = bf16_tensor_map<2>(map_wc, w_c_t, {fl, f}, {2 * fl}, {64u, (uint32_t)kc}, 128);
  return err;
}

template <int FP>
cudaError_t launch_level_bwd_wgmma(const bf16* plane, const float* xy, const int* cells,
                                   const uint8_t* mask, const int* counts, const bf16* g_plane,
                                   const bf16* g_c, const bf16* w_in, const bf16* b_in,
                                   const bf16* w_out_t, const bf16* w_c_t, bf16* d_clast,
                                   bf16* s_buf, bf16* h_buf, bf16* do_buf, bf16* dh_buf,
                                   bf16* ds_buf, int B, int N, int R, int F, int Fl, int shift,
                                   cudaStream_t stream) {
  constexpr bool kSplit = FP == 512;
  using C = std::conditional_t<kSplit, LevelBwdSplitCfg, LevelBwdCfg<FP>>;
  CUtensorMap map_wi, map_wo, map_wc;
  cudaError_t err = bwd_tensor_maps(&map_wi, &map_wo, &map_wc, w_in, w_out_t, w_c_t, F, Fl,
                                    C::kKC);
  if (err != cudaSuccess) return err;
  auto kernel = [] {
    if constexpr (kSplit) {
      return fused_level_bwd_wgmma_split;
    } else {
      return fused_level_bwd_wgmma<FP>;
    }
  }();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::kBM - 1) / C::kBM, B);
  kernel<<<grid, kBwdThreads, C::kSmem, stream>>>(map_wi, map_wo, map_wc, plane, xy, cells, mask,
                                                  counts, g_plane, g_c, b_in, d_clast, s_buf,
                                                  h_buf, do_buf, dh_buf, ds_buf, N, R, F, Fl,
                                                  shift);
  return cudaGetLastError();
}

// The plan's width class (tile_plan.level_bwd_plan): F rounded up to 64 .. 512.
inline int level_bwd_fp(int F) { return F <= 64 ? 64 : F <= 128 ? 128 : F <= 256 ? 256 : 512; }

template <int FP>
void level_bwd_plan_of(int F, int Fl, int* out) {
  constexpr bool kSplit = FP == 512;
  using C = std::conditional_t<kSplit, LevelBwdSplitCfg, LevelBwdCfg<FP>>;
  int slots = 0;
  if constexpr (!kSplit) slots = C::kSlots;
  const int v[] = {FP,
                   kSplit ? 1 : 0,
                   C::kBM,
                   kBwdSlice,
                   kBwdSlice,
                   slots,
                   C::kStages,
                   C::kNC,
                   C::kKC,
                   C::kNS,
                   (2 * F + kBwdSlice - 1) / kBwdSlice,
                   (F + kBwdSlice - 1) / kBwdSlice,
                   (Fl + C::kNC - 1) / C::kNC,
                   (F + C::kKC - 1) / C::kKC,
                   static_cast<int>(C::kSmem)};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// Phase 1 of K5 in bf16 (level_bwd.cu's entry points for the others): plane
// (B,R,R,F), xy (B,N,2) f32, cells (B,N) finest Morton ids, mask (B,N) u8,
// K4's counts (B,R,R) i32, the cotangents g_plane (B,R,R,F), g_c (B,N,F);
// weights row-major: w_in (F,2F), b_in (2F), and the transposes w_out_t
// (F,2F), w_c_t (F,Fl); w_in_t is not read (the row pass reads W_in's
// boxes both ways). Outputs: d_clast (B,N,Fl) and the rows s_buf (B*N,F),
// h_buf (B*N,2F), do_buf (B*N,F), dh_buf (B*N,2F), ds_buf (B*N,F). K5's
// bf16 rule (level_bwd_kernel.py:206-256). F <= 512 and F, Fl multiples of
// 8, every bf16 tensor 16-byte aligned.
int t2h_fused_level_bwd_bf16(const bf16* plane, const float* xy, const int* cells,
                             const uint8_t* mask, const int* counts, const bf16* g_plane,
                             const bf16* g_c, const bf16* w_in, const bf16* b_in,
                             const bf16* w_out_t, const bf16* w_c_t, const bf16* w_in_t,
                             bf16* d_clast, bf16* s_buf, bf16* h_buf, bf16* do_buf,
                             bf16* dh_buf, bf16* ds_buf, int B, int N, int R, int F, int Fl,
                             int shift, cudaStream_t stream) {
  (void)w_in_t;
  const void* ptrs[] = {plane, g_plane, g_c, w_in, w_out_t, w_c_t, d_clast,
                        s_buf, h_buf, do_buf, dh_buf, ds_buf};
  bool aligned = true;
  for (const void* p : ptrs) aligned = aligned && aligned16(p);
  if (F > 512 || F <= 0 || F % 8 || Fl % 8 || Fl <= 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * N == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
#define T2H_BWD(FP)                                                                           \
  case FP:                                                                                    \
    err = launch_level_bwd_wgmma<FP>(plane, xy, cells, mask, counts, g_plane, g_c, w_in,     \
                                     b_in, w_out_t, w_c_t, d_clast, s_buf, h_buf, do_buf,    \
                                     dh_buf, ds_buf, B, N, R, F, Fl, shift, stream);         \
    break;
  switch (level_bwd_fp(F)) {
    T2H_BWD(64)
    T2H_BWD(128)
    T2H_BWD(256)
    default:
    T2H_BWD(512)
  }
#undef T2H_BWD
  return static_cast<int>(err);
}

// The row pass's plan at (F, Fl), the integers of tile_plan.level_bwd_plan
// in the order of tile_plan.LEVEL_BWD_PLAN_KEYS -> out[15]. Returns 0, or
// cudaErrorInvalidValue past F = 512.
int t2h_level_bwd_plan_bf16(int F, int Fl, int* out) {
  if (F <= 0 || F > 512) return static_cast<int>(cudaErrorInvalidValue);
  switch (level_bwd_fp(F)) {
    case 64:
      level_bwd_plan_of<64>(F, Fl, out);
      break;
    case 128:
      level_bwd_plan_of<128>(F, Fl, out);
      break;
    case 256:
      level_bwd_plan_of<256>(F, Fl, out);
      break;
    default:
      level_bwd_plan_of<512>(F, Fl, out);
  }
  return 0;
}

}  // extern "C"
