// K4 in bf16: one ALTO level round trip's per-point MLP on bf16 plane,
// c_last and weights (xy f32), the Hopper version of _level_kernel in
// tomosar2height_tpu/ops/pallas/level_kernel.py:110 (launched by
// _fused_level_impl) under its bf16 rule (:234-258). Per point: the bilinear
// sample s of the (B,R,R,F) plane (border clamp, align_corners=True; the
// four weights cut to bf16, the sample summed in f32 and rounded once,
// bilinear.cuh), h = relu(bf16(bf16(s W_in) + b_in)), o = bf16(h W_out) +
// b_out, + bf16(c_last W_c), + b_c, each add rounded; o = 0 on padding rows
// -> c_out. The plane's scatter-mean of c_out is csrc/pool2.cu's
// scatter_runs<bf16>, which the wrapper launches after this.
//
// Bound on the H100: the MACs, 4 F^2 + F Fl a point (the flagship's eight
// levels 2.1M, the 32^2 level with F = 512 alone 1.18M): 0.53 ms at 989
// TFLOP/s for a batch-8 forward. What a block streams instead: every block
// reads all three weight matrices (2.36 MB at F = 512, Fl = 256), so the L2
// -> SM traffic is (rows / rows a block) x that, 6 GB at 64 rows a block.
// The design, on warpgroup products fed by the TMA (wgmma_bf16.cuh):
//
// - Rows a block: 128 (two consumer warpgroups of 64 rows, each holding
//   its rows' o, F / 2 f32 registers a thread) where F <= 256, so that each
//   weight byte read from L2 serves 128 rows. At F = 512 a warpgroup's 64
//   rows x 512 columns of o would take 256 registers a thread: there a
//   block owns 64 rows and the two warpgroups split o's columns (256 each,
//   128 registers), and the hidden chunk's columns too, sharing the chunk
//   through shared memory (kCols).
// - Weights by TMA: thread 0 keeps an mbarrier ring full with the tile
//   sequence the products consume, per hidden chunk of kHC columns W_in's
//   (kKI rows x kHC columns a stage) then W_out's (kKO rows x F columns),
//   then c_last's boxes (kKO columns x the block's rows, a 3-D map (Fl, N,
//   B): zero past N and Fl) with W_c's rows; a slot is loaded again once
//   both warpgroups have released it. No producer warp: ptxas caps a block
//   of 288 threads at 168 registers a thread, and o with the hidden chunk
//   take 160 at F = 256 and 512; 256 threads may take 255. Each weight is a
//   row-major (in, out) matrix read as 64-column boxes in the 128-byte
//   swizzle: wgmma's B operand N-major (its transpose bit), zero past F, 2F
//   and Fl.
// - The sample: the threads compute it before the products, a
//   thread a row and 8 channels (four 16-byte corner loads of the plane),
//   and store it in the swizzled K-major layout wgmma reads as A (64-column
//   blocks of 128-byte rows, the swizzle that TMA would write).
// - The hidden chunk: h_c = relu(bf16(bf16(s W_in[:, c]) + b_in)) (64 rows
//   x 64 columns a warpgroup, wgmma m64n64k16 into 32 f32 registers), then
//   rounded to bf16 into shared memory in the same K-major layout (a
//   warpgroup's own tile where F <= 256, the two halves of one 64 x 128
//   tile at F = 512) and o += h_c W_out[c, :] (m64nNk16, N = F or F / 2) with
//   A from there. Shared memory rather than wgmma's register A: at F = 512
//   both warpgroups read the whole chunk; one layout serves both forms.
// - The separately rounded c_last W_c term comes last: after the hidden
//   chunks, o1 = bf16(bf16(h W_out) + b_out) is parked (bf16) where the
//   sample was, o's registers take c_last W_c, and the epilogue adds
//   bf16(c_last W_c), then b_c, each add rounded (the same rounding points
//   as JAX's order).
// - Ordering: each c_out element written once, from registers; no split-K,
//   no atomics: bit-equal run to run. Blocks whose rows are all padding
//   write zeros and skip the products and the loads.
//
// Widths (FP: F rounded up to 64 .. 512, one instance each; the host plan
// is tile_plan.level_plan, mirrored here by LevelWgmmaCfg and level_fp):
// F <= 256 in 128-row blocks, F = 512 in 64-row blocks, any Fl (c_last is
// streamed in kKO-column boxes: Fl = 1024 at a depth-6 U-Net's first up
// level). F and Fl must be multiples of 8 and the tensors 16-byte aligned
// (the TMA's strides; the plane's 16-byte loads): the wrapper pads other
// widths with zero columns, which change no sum.
//
// Shared memory: the sample kBM x FP bf16, the hidden tiles 16 KiB, the
// ring (LevelWgmmaCfg: 3-5 stages, 24-36 KiB each): 105 KiB at FP = 64 (two
// blocks an SM), 177 KiB at 128, 201 KiB at 256, 189 KiB at 512.

#include "bilinear.cuh"
#include "wgmma_bf16.cuh"

namespace t2h {

template <int FP>
struct LevelWgmmaCfg {
  static constexpr bool kCols = FP == 512;         // o's columns split between the warpgroups
  static constexpr int kBM = kCols ? 64 : 128;     // rows a block
  static constexpr int kHC = kCols ? 128 : 64;     // hidden columns a chunk
  static constexpr int kON = kCols ? FP / 2 : FP;  // o's columns a warpgroup
  static constexpr int kKI = FP == 64 ? 64 : 128;  // W_in rows a stage
  static constexpr int kKO = FP <= 128 ? 64 : 32;  // W_out / W_c rows, c_last columns a stage
  // two warpgroups and no producer warp: ptxas caps a block of 288 (or 384)
  // threads at 168 registers a thread, and o with the hidden chunk alone
  // take 160 at F = 256 and 512; 256 threads may take 255
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = FP == 64 ? 2 : 1;
  static constexpr int kABytes = kBM * kKO * 2;     // the c_last box
  static constexpr int kBIn = kKI * kHC * 2;        // W_in's boxes
  static constexpr int kBOut = kKO * FP * 2;        // W_out's or W_c's boxes
  static constexpr int kStage = kABytes + (kBIn > kBOut ? kBIn : kBOut);
  static constexpr int kSBytes = kBM * FP * 2;  // the sample, then o1
  static constexpr int kHBytes = 16 * 1024;     // two 64 x 64 tiles, or one 64 x 128
  static constexpr int kStages = FP == 64 ? 3 : FP == 128 ? 4 : FP == 256 ? 5 : 3;
  static constexpr size_t kSmem = 1024 + kSBytes + kHBytes + (size_t)kStages * kStage;
  static_assert(kSmem + 4096 <= 232448 / kMinBlocks, "shared memory");
  static_assert(FP % kKI == 0 && kHC % kKO == 0, "stages inside the sample and the chunk");
};

// The byte offset of element (r, k) of a K-major bf16 tile of `rows` rows in
// 64-column blocks of 128-byte rows, 128-byte swizzle (16-byte chunk j of
// row r at chunk j ^ (r % 8)).
__device__ __forceinline__ int kmajor_at(int r, int k, int rows) {
  return (k >> 6) * rows * 128 + r * 128 + ((((k & 63) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2;
}

// The A descriptor of k16 step kq of such a tile, from row r0.
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int rows, int r0, int kq) {
  return gmma_desc(tile + (kq >> 2) * rows * 128 + r0 * 128 + (kq & 3) * 32, 16, 1024, 1);
}

template <int FP>
__global__ void __launch_bounds__(LevelWgmmaCfg<FP>::kThreads, LevelWgmmaCfg<FP>::kMinBlocks)
fused_level_wgmma(const __grid_constant__ CUtensorMap map_c,
                  const __grid_constant__ CUtensorMap map_wi,
                  const __grid_constant__ CUtensorMap map_wo,
                  const __grid_constant__ CUtensorMap map_wc, const bf16* __restrict__ plane,
                  const float* __restrict__ xy, const uint8_t* __restrict__ mask,
                  const bf16* __restrict__ b_in, const bf16* __restrict__ b_out,
                  const bf16* __restrict__ b_c, bf16* __restrict__ c_out, int N, int R, int F,
                  int Fl) {
  using C = LevelWgmmaCfg<FP>;
  constexpr int S = C::kStages;
  constexpr int kBM = C::kBM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int s_valid[kBM];
  __shared__ Corner s_corner[kBM];
  __shared__ int s_any;
  uint8_t* s_tile = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* h_tiles = s_tile + C::kSBytes;
  uint8_t* ring = h_tiles + C::kHBytes;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int rows = min(kBM, N - i0);
  const long long row_b = (long long)b * N + i0;

  if (tid == 0) {
    s_any = 0;
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < kBM) {
    const int i = i0 + tid;
    int valid = 0;
    Corner corner = {};
    if (i < N) {
      const long long p = (long long)b * N + i;
      valid = mask[p] != 0;
      corner = bilinear_corner(xy[2 * p], xy[2 * p + 1], R);
      if (valid) s_any = 1;
    }
    s_valid[tid] = valid;
    s_corner[tid] = corner;
  }
  __syncthreads();
  if (!s_any) {  // every row is padding: c_out is exactly 0 there
    uint4* dst = reinterpret_cast<uint4*>(c_out + row_b * F);
    for (int e = tid; e < rows * F / 8; e += C::kThreads) dst[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  const int nH = (2 * F + C::kHC - 1) / C::kHC;
  const int nIn = (F + C::kKI - 1) / C::kKI;
  constexpr int nOut = C::kHC / C::kKO;
  const int nC = (Fl + C::kKO - 1) / C::kKO;

  // The tile sequence, issued by thread 0: S tiles ahead, then each slot
  // again once every thread has released the tile before in it (release
  // below). Tile t: per hidden chunk nIn tiles of W_in, nOut of W_out; then
  // nC tiles of c_last with W_c.
  const int per = nIn + nOut;
  const int n_tiles = nH * per + nC;
  auto issue = [&](int t) {
    if (t >= n_tiles) return;
    const int s = t % S;
    if (t >= S) mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
    uint8_t* st = ring + (size_t)s * C::kStage;
    if (t < nH * per) {
      const int c = t / per, v = t - c * per;
      if (v < nIn) {
        mbar_arrive_expect_tx(&full[s], C::kBIn);
#pragma unroll
        for (int i = 0; i < C::kHC / 64; ++i)
          tma_load_2d(st + C::kABytes + i * C::kKI * 128, &map_wi, &full[s],
                      c * C::kHC + 64 * i, v * C::kKI);
      } else {
        mbar_arrive_expect_tx(&full[s], C::kBOut);
#pragma unroll
        for (int i = 0; i < FP / 64; ++i)
          tma_load_2d(st + C::kABytes + i * C::kKO * 128, &map_wo, &full[s], 64 * i,
                      c * C::kHC + (v - nIn) * C::kKO);
      }
    } else {
      const int v = t - nH * per;
      mbar_arrive_expect_tx(&full[s], C::kABytes + C::kBOut);
      tma_load_3d(st, &map_c, &full[s], v * C::kKO, i0, b);
#pragma unroll
      for (int i = 0; i < FP / 64; ++i)
        tma_load_2d(st + C::kABytes + i * C::kKO * 128, &map_wc, &full[s], 64 * i,
                    v * C::kKO);
    }
  };
  if (tid == 0)
    for (int t = 0; t < S; ++t) issue(t);  // in flight while the sample is made

  // --- the sample -> s_tile (zeros past F and on padding rows) ---------------
  // kU tasks (a row and 8 channels) a thread at a time, their 4 kU corner
  // loads issued before any is used
  {
    const bf16* pl = plane + (long long)b * R * R * F;
    constexpr int kChunks = FP / 8, kU = 4;
    static_assert(kBM * kChunks % (kU * C::kThreads) == 0, "whole rounds of tasks");
    for (int e0 = tid; e0 < kBM * kChunks; e0 += kU * C::kThreads) {
      uint4 v[kU][4];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * C::kThreads, r = e / kChunks, k = 8 * (e - r * kChunks);
        ok[u] = k < F && r < rows && s_valid[r];
        if (ok[u]) {
          const Corner cr = s_corner[r];
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
        const int e = e0 + u * C::kThreads, r = e / kChunks, k = 8 * (e - r * kChunks);
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u]) {
          float w[4];
          cut_weights(s_corner[r], w);
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
        *reinterpret_cast<uint4*>(s_tile + kmajor_at(r, k, kBM)) = out;
      }
    }
  }
  fence_async_shared();  // the sample, written by threads, read by wgmma
  named_barrier(1, C::kThreads);

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = C::kCols ? 0 : 64 * wg;        // this warpgroup's rows
  const int oc0 = C::kCols ? C::kON * wg : 0;   // its o columns
  const int hc0 = C::kCols ? 64 * wg : 0;       // its columns of a hidden chunk
  // the hidden tile(s) and the barrier that orders them: a warpgroup's own
  // where F <= 256, both warpgroups' at F = 512
  uint8_t* h_base = h_tiles + (C::kCols ? 0 : wg * 8192);
  uint8_t* h_mine = h_tiles + wg * 8192;
  const int hbar = C::kCols ? 1 : 2 + wg;
  const int hcount = C::kCols ? C::kThreads : 128;
  const int F16 = (F + 15) & ~15;
  const int rr = 16 * warp + lane / 4;  // fragment rows rr, rr + 8 of the warpgroup
  const int q2 = 2 * (lane % 4);        // fragment column pairs 8j + q2

  int it = 0, held = -1;  // the tile counter; the tile whose products may be in flight
  auto acquire = [&]() {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    wgmma_fence();
    return static_cast<const uint8_t*>(ring + (size_t)s * C::kStage);
  };
  auto release = [&]() {  // tile `held` read: its slot takes tile held + S
    if (held >= 0) {
      mbar_arrive(&empty[held % S]);
      if (tid == 0) issue(held + S);
    }
  };
  auto retire = [&]() {  // commit this tile's products, release the tile before
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

  float o[C::kON / 2];
#pragma unroll
  for (int i = 0; i < C::kON / 2; ++i) o[i] = 0.0f;
  fence_acc(o);
  float hacc[32];
  for (int c = 0; c < nH; ++c) {
    // h_c = s W_in[:, c * kHC + hc0 ..+ 64]
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.0f;
    fence_acc(hacc);
    for (int v = 0; v < nIn; ++v) {
      const uint8_t* st = acquire() + C::kABytes + (hc0 / 64) * C::kKI * 128;
      const int steps = min(C::kKI, F16 - v * C::kKI) / 16;
      for (int kk = 0; kk < steps; ++kk)
        wgmma_bf16<64, 0, 1>(hacc, kmajor_desc(s_tile, kBM, r0, v * (C::kKI / 16) + kk),
                             gmma_desc(st + kk * 2048, C::kKI * 128, 1024, 1));
      retire();
    }
    drain();
    fence_acc(hacc);
    // relu(bf16(bf16(.) + b_in)) -> the hidden tile (0 past 2F), once every
    // product of the chunk before has read it
    named_barrier(hbar, hcount);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = c * C::kHC + hc0 + 8 * j + q2;
      const float bi0 = n < 2 * F ? to_f32(b_in[n]) : 0.0f;
      const float bi1 = n + 1 < 2 * F ? to_f32(b_in[n + 1]) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr + 8 * h;
        const float v0 = n < 2 * F ? round_as<bf16>(round_as<bf16>(hacc[4 * j + 2 * h]) + bi0)
                                   : 0.0f;
        const float v1 =
            n + 1 < 2 * F ? round_as<bf16>(round_as<bf16>(hacc[4 * j + 2 * h + 1]) + bi1) : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(h_mine + kmajor_at(r, 8 * j + q2, 64)) =
            __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
    }
    fence_async_shared();
    named_barrier(hbar, hcount);
    // o += h_c W_out[c * kHC .., oc0 ..+ kON]
    for (int v = 0; v < nOut; ++v) {
      const uint8_t* st = acquire() + C::kABytes + (oc0 / 64) * C::kKO * 128;
#pragma unroll
      for (int kk = 0; kk < C::kKO / 16; ++kk)
        wgmma_bf16<C::kON, 0, 1>(o, kmajor_desc(h_base, 64, 0, v * (C::kKO / 16) + kk),
                                 gmma_desc(st + kk * 2048, C::kKO * 128, 1024, 1));
      retire();
    }
  }
  drain();
  fence_acc(o);

  // o1 = bf16(bf16(h W_out) + b_out), parked (bf16) where the sample was,
  // once every product has read the sample; o then takes c_last W_c
  named_barrier(hbar, hcount);
#pragma unroll
  for (int j = 0; j < C::kON / 8; ++j) {
    const int n = oc0 + 8 * j + q2;
    const float bo0 = n < F ? to_f32(b_out[n]) : 0.0f;
    const float bo1 = n + 1 < F ? to_f32(b_out[n + 1]) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + rr + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(s_tile + kmajor_at(r, n, kBM)) =
          __floats2bfloat162_rn(round_as<bf16>(o[4 * j + 2 * h]) + bo0,
                                round_as<bf16>(o[4 * j + 2 * h + 1]) + bo1);
      o[4 * j + 2 * h] = 0.0f;
      o[4 * j + 2 * h + 1] = 0.0f;
    }
  }
  fence_acc(o);
  for (int v = 0; v < nC; ++v) {
    const uint8_t* st = acquire();
#pragma unroll
    for (int kk = 0; kk < C::kKO / 16; ++kk)
      wgmma_bf16<C::kON, 0, 1>(
          o, gmma_desc(st + r0 * C::kKO * 2 + kk * 32, 16, 8 * C::kKO * 2, C::kKO == 64 ? 1 : 2),
          gmma_desc(st + C::kABytes + (oc0 / 64) * C::kKO * 128 + kk * 2048, C::kKO * 128, 1024,
                    1));
    retire();
  }
  drain();
  fence_acc(o);

  // o = bf16(o1 + bf16(c_last W_c)), then + b_c rounded; 0 on padding rows
#pragma unroll
  for (int j = 0; j < C::kON / 8; ++j) {
    const int n = oc0 + 8 * j + q2;
    if (n >= F) continue;
    const float bc0 = to_f32(b_c[n]), bc1 = to_f32(b_c[n + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + rr + 8 * h;
      if (r >= rows) continue;
      const float2 o1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(s_tile + kmajor_at(r, n, kBM)));
      float v0 = round_as<bf16>(o1.x + round_as<bf16>(o[4 * j + 2 * h]));
      float v1 = round_as<bf16>(o1.y + round_as<bf16>(o[4 * j + 2 * h + 1]));
      v0 = s_valid[r] ? v0 + bc0 : 0.0f;
      v1 = s_valid[r] ? v1 + bc1 : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(c_out + (row_b + r) * F + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int FP>
cudaError_t launch_level_wgmma(const bf16* plane, const bf16* clast, const float* xy,
                               const uint8_t* mask, const bf16* w_in, const bf16* b_in,
                               const bf16* w_out, const bf16* b_out, const bf16* w_c,
                               const bf16* b_c, bf16* c_out, int B, int N, int R, int F, int Fl,
                               cudaStream_t stream) {
  using C = LevelWgmmaCfg<FP>;
  CUtensorMap map_c, map_wi, map_wo, map_wc;
  const uint64_t f = F, fl = Fl;
  cudaError_t err = bf16_tensor_map<3>(&map_c, clast, {fl, (uint64_t)N, (uint64_t)B},
                                       {fl * 2, fl * 2 * N},
                                       {(uint32_t)C::kKO, (uint32_t)C::kBM, 1u}, C::kKO * 2);
  if (err == cudaSuccess)
    err = bf16_tensor_map<2>(&map_wi, w_in, {2 * f, f}, {4 * f}, {64u, (uint32_t)C::kKI}, 128);
  if (err == cudaSuccess)
    err = bf16_tensor_map<2>(&map_wo, w_out, {f, 2 * f}, {2 * f}, {64u, (uint32_t)C::kKO}, 128);
  if (err == cudaSuccess)
    err = bf16_tensor_map<2>(&map_wc, w_c, {f, fl}, {2 * f}, {64u, (uint32_t)C::kKO}, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_level_wgmma<FP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::kBM - 1) / C::kBM, B);
  fused_level_wgmma<FP><<<grid, C::kThreads, C::kSmem, stream>>>(
      map_c, map_wi, map_wo, map_wc, plane, xy, mask, b_in, b_out, b_c, c_out, N, R, F, Fl);
  return cudaGetLastError();
}

// The plan's width class (tile_plan.level_plan): F rounded up to 64 .. 512.
inline int level_fp(int F) { return F <= 64 ? 64 : F <= 128 ? 128 : F <= 256 ? 256 : 512; }

}  // namespace t2h

using namespace t2h;

extern "C" {

// plane (B,R,R,F) NHWC, c_last (B,N,Fl), weights row-major (in, out): w_in
// (F,2F), w_out (2F,F), w_c (Fl,F), biases, c_out (B,N,F), all bf16; xy
// (B,N,2) f32, mask (B,N) u8 -> c_out (0 on padding rows), K4's bf16 rule
// (level_kernel.py:234-258). F <= 512 and F, Fl multiples of 8, every
// tensor 16-byte aligned; its plane is t2h_scatter_runs_bf16.
int t2h_fused_level_bf16(const bf16* plane, const bf16* clast, const float* xy,
                         const uint8_t* mask, const bf16* w_in, const bf16* b_in,
                         const bf16* w_out, const bf16* b_out, const bf16* w_c,
                         const bf16* b_c, bf16* c_out, int B, int N, int R, int F, int Fl,
                         cudaStream_t stream) {
  if (F > 512 || F % 8 || Fl % 8 || Fl <= 0 || !aligned16(plane) || !aligned16(clast) ||
      !aligned16(w_in) || !aligned16(w_out) || !aligned16(w_c) || !aligned16(c_out))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * N * F == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
#define T2H_LEVEL(FP)                                                                         \
  case FP:                                                                                    \
    err = launch_level_wgmma<FP>(plane, clast, xy, mask, w_in, b_in, w_out, b_out, w_c, b_c, \
                                 c_out, B, N, R, F, Fl, stream);                             \
    break;
  switch (level_fp(F)) {
    T2H_LEVEL(64)
    T2H_LEVEL(128)
    T2H_LEVEL(256)
    default:
    T2H_LEVEL(512)
  }
#undef T2H_LEVEL
  return static_cast<int>(err);
}

}  // extern "C"
