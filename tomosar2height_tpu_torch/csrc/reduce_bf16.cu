// K5's weight sums in bf16: dw = A^T B and db = colsum(B) over all M rows of
// the row pass's bf16 scratch rows (A (M, Ka), B (M, Nb), row-major), f32
// sums rounded to bf16 once. The Hopper version of the weight-gradient sums
// of _level_bwd_kernel in tomosar2height_tpu/ops/pallas/level_bwd_kernel.py
// (the dwi_ref / dbi_ref ... accumulators, :260-279, held in f32 and cast to
// the weights' dtype at level_kernel.py:653-659); phase 2 of level_bwd.cu in
// bf16. The fp32 sums stay on 3xTF32 mma.sync (level_bwd.cu atb_mma): TF32
// wgmma takes its operands K-major only, and these are M-major.
//
// Bound on the H100: the bytes. The flagship's 24 sums read 3.76 GB of bf16
// rows (1.12 ms at 3.35 TB/s) for 684 GFLOP (0.69 ms at 989 TFLOP/s): 182
// FLOP a byte, under the card's ~295. So the kernel streams the rows from
// HBM about once and keeps the tensor cores from being what waits:
//
// - Loads: a block owns one BK x BN output tile (BK = 64 or 128 rows of dw,
//   BN = 64, 128 or 256 columns) and one contiguous split of the rows. One
//   producer warp streams the split through a ring of kStages shared stages
//   of kRows = 64 rows: per stage, TMA 2-D loads of 64-column boxes of A and
//   B (128-byte swizzle, zero past M, Ka and Nb), completing on the stage's
//   full mbarrier. No thread spends registers or instructions on addresses.
// - Products: one consumer warpgroup per 64 rows of the tile runs
//   wgmma.mma_async m64nBNk16 on the stage, A^T and B both MN-major in shared
//   memory (the transpose bits), four k16 steps a stage, the stage's
//   products in flight while it releases the one before (its empty
//   mbarrier, each consumer warp arriving).
// - Re-reads: a 128 x 256 tile (two warpgroups, 128 f32 accumulators a
//   thread) reads A Nb / 256 times and B Ka / 128 times; the blocks of one
//   split are launched side by side, so those re-reads come from L2. (Two
//   blocks along Ka in a cluster, B multicast by the TMA so that it crosses
//   from L2 once for both, ran no faster on the card: PERF.md.) The
//   wide sums are bound in the SM instead: per k16 step both warpgroups'
//   products read B from shared memory, and the TMA writes the next stages,
//   about 80 + 48 bytes a clock at the bf16 peak, against the 128 that
//   shared memory serves.
// - Splits: about one block an SM (tiles x splits <= the SMs), each split a
//   whole number of stages; a second pass (sum_splits_bf16) adds the splits'
//   f32 partial tiles in a fixed order, eight threads an output, and rounds
//   once. Bit-equal run to run.
// - Bias: db is summed on the CUDA cores from the B stages already in
//   shared memory, while the stage's wgmmas run: block (x, y) of a split
//   sums the stages s with s % ny == y (ny tiles along Ka), so every block
//   carries an equal share and the JAX kernel's `ones @ d_h` costs no extra
//   bytes; the ny partial rows of each split are added in sum_splits_bf16
//   in a fixed order.
// - Numerics: bf16 products are exact in f32; each wgmma adds its 16
//   products into the running f32 sum, truncating at its exponent. A chain
//   is one block's split (M / splits rows: 1,280-20,480 at the flagship's
//   M = 163,840, so at most 1,280 k16 adds), and the splits join by rounded
//   f32 adds; the error stays far below the one bf16 rounding of the
//   output (chip_smoke.py logs the worst distance from a float64 product).
//
// The host plan (tile, splits, rows a split) is mirrored by
// ops/cuda/tile_plan.py, which tests/test_torch_tile_plan.py emulates.

#include "wgmma_bf16.cuh"

namespace t2h {

constexpr int kRows = 64;               // rows a stage
constexpr int kBox = 64;                // columns of a TMA box (128 bytes)
constexpr int kBoxBytes = kRows * 128;  // one box of one stage
constexpr int kRingBytes = 200 * 1024;  // shared memory the ring may take

template <int BK, int BN>
struct ReduceCfg {
  static constexpr int kWG = BK / 64;                   // consumer warpgroups
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;      // + the producer warp
  static constexpr int kABoxes = BK / kBox, kBBoxes = BN / kBox;
  static constexpr int kStage = (kABoxes + kBBoxes) * kBoxBytes;
  static constexpr int kStages = kRingBytes / kStage < 8 ? kRingBytes / kStage : 8;
  // bias: each consumer thread sums 8 columns (one 16-byte chunk) of a
  // group of rows; kGroups row groups
  static constexpr int kChunks = BN / 8;
  static constexpr int kGroups = kConsumers / kChunks;
  static constexpr int kBiasFloats = kGroups * BN;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + sizeof(float) * kBiasFloats;
  static_assert(kRows % kGroups == 0, "bias row groups");
};

// The host plan, mirrored by ops/cuda/tile_plan.py: the tile's side along
// Ka (BK) and along Nb (BN), and the rows of a split (a whole number of
// stages).
inline int reduce_bk(int ka) { return ka <= 64 ? 64 : 128; }
inline int reduce_bn(int nb) { return nb <= 64 ? 64 : nb <= 128 ? 128 : 256; }
inline long long reduce_rows_per_split(long long m, int splits) {
  const long long per = (m + splits - 1) / splits;
  return (per + kRows - 1) / kRows * kRows;
}

template <int BK, int BN>
__global__ void __launch_bounds__(ReduceCfg<BK, BN>::kThreads, 1)
atb_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          int M, int Ka, int Nb, long long rows_per_split, bool bias, int part_rows,
          float* __restrict__ part) {
  using C = ReduceCfg<BK, BN>;
  constexpr int S = C::kStages;
  constexpr int kWarps = C::kConsumers / 32;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias_part = reinterpret_cast<float*>(ring + (size_t)S * C::kStage);

  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BK;
  const int ny = gridDim.y;
  const long long m_begin = blockIdx.z * rows_per_split;
  const long long m_end = min((long long)M, m_begin + rows_per_split);
  const int steps = m_end > m_begin ? static_cast<int>((m_end - m_begin + kRows - 1) / kRows) : 0;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {  // the producer warp: one thread issues the loads
    if (tid == C::kConsumers) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], C::kStage);
        uint8_t* st = ring + (size_t)s * C::kStage;
        const int row = static_cast<int>(m_begin) + it * kRows;
#pragma unroll
        for (int i = 0; i < C::kABoxes; ++i)
          tma_load_2d(st + i * kBoxBytes, &map_a, &full[s], k0 + i * kBox, row);
#pragma unroll
        for (int i = 0; i < C::kBBoxes; ++i)
          tma_load_2d(st + (C::kABoxes + i) * kBoxBytes, &map_b, &full[s], n0 + i * kBox, row);
      }
    }
  } else {
    // consumers: warpgroup wg owns dw rows k0 + 64 wg .. + 64
    const int wg = tid / 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    // bias: thread tid sums chunk `ch` (columns 8 ch .. + 8) of rows g, g +
    // kGroups, ... of a stage
    const int ch = tid % C::kChunks, g = tid / C::kChunks;
    float bsum[8] = {};
    auto release = [&](int s) {  // this warp's reads of stage s are done
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    for (int it = 0; it < steps; ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* st = ring + (size_t)s * C::kStage;
      const uint8_t* a_tile = st + wg * kBoxBytes;
      const uint8_t* b_tile = st + C::kABoxes * kBoxBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        // MN-major: 16 rows (two 8-row groups) a k16 step
        const uint64_t da = gmma_desc(a_tile + kk * 2048, kBoxBytes, 1024, 1);
        const uint64_t db = gmma_desc(b_tile + kk * 2048, kBoxBytes, 1024, 1);
        wgmma_bf16<BN, 1, 1>(acc, da, db);
      }
      wgmma_commit();
      if (bias && it % ny == static_cast<int>(blockIdx.y)) {
        // the chunk of box ch / 8 at swizzled position (ch % 8) ^ (r % 8)
        const uint8_t* box = b_tile + (ch / 8) * kBoxBytes;
#pragma unroll
        for (int i = 0; i < kRows / C::kGroups; ++i) {
          const int r = g + i * C::kGroups;
          const uint4 v =
              *reinterpret_cast<const uint4*>(box + r * 128 + (((ch % 8) ^ (r % 8)) << 4));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
            bsum[2 * j] += f.x;
            bsum[2 * j + 1] += f.y;
          }
        }
      }
      wgmma_wait<1>();  // the stage before this one is read: release it
      if (it > 0) release((it - 1) % S);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    float* out = part + (long long)blockIdx.z * part_rows * Nb;
    const int w = (tid % 128) / 32;
    const int row0 = k0 + 64 * wg + 16 * w + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = row0 + 8 * h;
        if (k < Ka && n < Nb)
          *reinterpret_cast<float2*>(out + (long long)k * Nb + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    if (bias) {  // this block's share of the column sums, its row groups added in order
#pragma unroll
      for (int e = 0; e < 8; ++e) bias_part[g * BN + 8 * ch + e] = bsum[e];
      named_barrier(1, C::kConsumers);
      for (int c = tid; c < BN && n0 + c < Nb; c += C::kConsumers) {
        float v = 0.0f;
        for (int q = 0; q < C::kGroups; ++q) v += bias_part[q * BN + c];
        out[(long long)(Ka + blockIdx.y) * Nb + n0 + c] = v;
      }
    }
  }
}

// dw (Ka x Nb) and db (Nb, where not null) in bf16 from the splits' f32
// partial tiles: rows k < Ka of each split's part_rows x Nb, and the ny bias
// rows after them. A block of kSumX x kSumY threads takes kSumX consecutive
// outputs (coalesced loads); thread row y adds the partials q = y, y +
// kSumY, ... of its output in order (q runs over the splits, for the bias
// over the splits' bias rows), so that few outputs with many splits still
// spread over many threads; the kSumY sums then join in row order. A fixed
// order: the same sum every run.
constexpr int kSumX = 32, kSumY = 8, kUnroll = 4;

__global__ void __launch_bounds__(kSumX* kSumY)
sum_splits_bf16(const float* __restrict__ part, int splits, int Ka, int Nb, int part_rows,
                int ny, bf16* __restrict__ dw, bf16* __restrict__ db) {
  __shared__ float sums[kSumY][kSumX];
  const long long n_dw = (long long)Ka * Nb;
  const long long n_out = n_dw + (db != nullptr ? Nb : 0);
  const long long stride = (long long)part_rows * Nb;
  const int x = threadIdx.x, y = threadIdx.y;
  for (long long base = blockIdx.x * (long long)kSumX; base < n_out;
       base += (long long)gridDim.x * kSumX) {
    const long long t = base + x;
    // the partials q = y, y + kSumY, ... of output t; loaded kUnroll at a
    // time so that their loads overlap, added in order
    const int nq = t < n_dw ? splits : t < n_out ? splits * ny : 0;
    auto at = [&](int q) {
      return t < n_dw ? part[q * stride + t]
                      : part[(q / ny) * stride + (long long)(Ka + q % ny) * Nb + (t - n_dw)];
    };
    float s = 0.0f;
    int q = y;
    for (; q + (kUnroll - 1) * kSumY < nq; q += kUnroll * kSumY) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = at(q + u * kSumY);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += v[u];
    }
    for (; q < nq; q += kSumY) s += at(q);
    sums[y][x] = s;
    __syncthreads();
    if (y == 0 && t < n_out) {
      float v = sums[0][x];
      for (int r = 1; r < kSumY; ++r) v += sums[r][x];
      if (t < n_dw) {
        dw[t] = __float2bfloat16_rn(v);
      } else {
        db[t - n_dw] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();
  }
}

template <int BK, int BN>
cudaError_t launch_atb_wgmma(const bf16* A, const bf16* Bm, int M, int Ka, int Nb, bool bias,
                             int splits, float* part, cudaStream_t stream) {
  using C = ReduceCfg<BK, BN>;
  CUtensorMap map_a, map_b;
  const uint32_t box[2] = {kBox, kRows};
  cudaError_t err = bf16_tensor_map<2>(&map_a, A, {(uint64_t)Ka, (uint64_t)M},
                                       {(uint64_t)Ka * 2}, box, 128);
  if (err == cudaSuccess)
    err = bf16_tensor_map<2>(&map_b, Bm, {(uint64_t)Nb, (uint64_t)M}, {(uint64_t)Nb * 2}, box,
                             128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(atb_wgmma<BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const int ny = (Ka + BK - 1) / BK;
  const dim3 grid((Nb + BN - 1) / BN, ny, splits);
  atb_wgmma<BK, BN><<<grid, C::kThreads, C::kSmem, stream>>>(
      map_a, map_b, M, Ka, Nb, reduce_rows_per_split(M, splits), bias, Ka + (bias ? ny : 0), part);
  return cudaGetLastError();
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// The tiles of a (Ka x Nb) bf16 weight sum: the wrapper sizes its splits by
// them. Returns the count, not an error code.
int t2h_level_bwd_reduce_tiles_bf16(int Ka, int Nb) {
  const int bk = reduce_bk(Ka), bn = reduce_bn(Nb);
  return ((Ka + bk - 1) / bk) * ((Nb + bn - 1) / bn);
}

// K5's phase 2 on bf16 rows: A (M,Ka), Bm (M,Nb) -> dw = A^T Bm (Ka,Nb) and,
// when db is not null, db = colsum(Bm) (Nb), both bf16, their f32 sums
// rounded once (JAX's f32 accumulators cast to the weights' dtype,
// level_kernel.py:653-659). `splits` row splits; part: splits * (Ka + ny) *
// Nb floats of scratch with bias (ny = the tiles along Ka), splits * Ka * Nb
// without. Ka and Nb multiples of 8 and A, Bm 16-byte aligned (the TMA's
// row pitch), else cudaErrorInvalidValue: the wrapper pads other widths.
int t2h_level_bwd_reduce_bf16(const bf16* A, const bf16* Bm, int M, int Ka, int Nb,
                              int splits, float* part, bf16* dw, bf16* db,
                              cudaStream_t stream) {
  if (Ka % 8 || Nb % 8 || !aligned16(A) || !aligned16(Bm) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bias = db != nullptr;
  const int bk = reduce_bk(Ka), bn = reduce_bn(Nb);
  const int ny = (Ka + bk - 1) / bk;
  cudaError_t err;
#define T2H_ATB(BK, BN) launch_atb_wgmma<BK, BN>(A, Bm, M, Ka, Nb, bias, splits, part, stream)
  if (bk == 64) {
    err = bn == 64 ? T2H_ATB(64, 64) : bn == 128 ? T2H_ATB(64, 128) : T2H_ATB(64, 256);
  } else {
    err = bn == 64 ? T2H_ATB(128, 64) : bn == 128 ? T2H_ATB(128, 128) : T2H_ATB(128, 256);
  }
#undef T2H_ATB
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = (long long)Ka * Nb + (bias ? Nb : 0);
  const long long blocks = (n_out + kSumX - 1) / kSumX;
  sum_splits_bf16<<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536), dim3(kSumX, kSumY),
                    0, stream>>>(part, splits, Ka, Nb, Ka + (bias ? ny : 0), bias ? ny : 0,
                                 dw, db);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
