// One ALTO level round trip, forward: the Hopper version of _level_kernel in
// tomosar2height_tpu/ops/pallas/level_kernel.py (launched by _fused_level_impl).
//
// Per point: bilinear sample of the (B,R,R,F) plane (border clamp,
// align_corners=True), h = relu(s @ w_in + b_in), o = h @ w_out + b_out +
// c_last @ w_c + b_c, o = 0 on padding rows; then a masked scatter-mean of o
// into the plane at this level's resolution (cell = finest Morton id >> shift).
//
// The TPU kernel walks a sequential (batch, point-chunk) grid, keeps one
// tile's plane window and accumulator in VMEM and flushes the tile on its last
// chunk. Here a block owns kBM = 64 consecutive points. Its three GEMMs run on
// the tensor cores at fp32 accuracy (3xTF32 mma.sync, mma_tf32x3.cuh); the
// block's output o (64 x F) stays in registers from the first product to the
// epilogue (a warp owns 32 rows x F/8 columns at F = 128 and 512, of 16
// warps; F/4 of 8 warps at the other widths). In order:
//   1. o = c_last @ w_c: c_last comes through the shared A buffer in K-chunks
//      of FP columns (FP: F rounded up to a power of two >= 32), so any Fl
//      fits (Fl = 1024 at the first up level of a depth-6 U-Net);
//   2. the sample s -> A buffer, then for each 64-column chunk of the hidden
//      layer: h_c = relu(s @ w_in[:, chunk] + b_in) into a 64 x 64 shared
//      tile, o += h_c @ w_out[chunk, :]. The hidden layer (2F floats a row)
//      never exists whole, so 64 rows fit at F = 512.
// The weights stream through a ring of shared slots by cp.async, as one
// sequence of tiles (w_c's, then w_in's and w_out's chunk by chunk), so the
// next tiles' copies fly across the phase boundaries too; each slot is
// consumed after one block barrier. Shared strides are padded against bank
// conflicts. The plane scatter is an atomicAdd per output element into a
// zeroed (B,R,R,F) buffer, then a finalize pass divides by the counts.
//
// Bound on the H100: the MACs, ~1.9M per point per forward summed over the
// eight levels (the 32^2 level with F=512 alone 1.2M), three TF32 products
// each; the plane traffic is small beside it. 64 rows a block halve the
// weight reads from L2 of a 32-row block (4.5 MB a block at F = 512).
// Shared memory: 211 KiB at F = 512 (a 2-slot ring), 136 KiB at F = 256,
// 104 KiB at F = 128 (one block an SM), 88 KiB at F = 64 (two blocks of 8
// warps). Blocks whose 64 rows are all padding write zeros to
// c_out and skip the products. What holds it back: the hidden chunk's
// product gives each warp two m16n8 tiles a k8 step, so there the operand
// splits cost more issue slots than the MMAs; a wider chunk does not fit
// the shared memory at F = 512 beside the 64-row sample.

#include "bilinear.cuh"
#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace t2h {

constexpr int kBM = 64;   // points per block
constexpr int kHC = 64;   // hidden columns per chunk

// Per width class FP, the threads of a block and so the register cap
// (ptxas's counts and the A/B are in PERF.md):
// - F = 128 and 512: 512 threads, one block an SM, 128 registers a thread;
//   ptxas spills 116 and 208 bytes. At F = 512, 256 threads would hold 128
//   floats of o a thread: 255 registers spilled 1320 bytes and ran slower.
// - F = 256: 256 threads, one block an SM, 255 registers: o is 64 floats a
//   thread and nothing spills (ran faster than 512 threads with spills).
// - F <= 64: 256 threads, two blocks an SM, 128 registers (64-116 bytes
//   spilled).
// Warps are 2 row halves x kWQ column groups, of o and of the hidden chunk
// alike.
template <int FP>
struct LevelCfg {
  static constexpr int kT = FP == 128 || FP == 512 ? 512 : 256;
  static constexpr int kWQ = kT / 64;
  static constexpr int kWN = FP / kWQ;  // a warp's o columns
  static constexpr int kNT = kWN / 8;
  static constexpr int kWH = kHC / kWQ;  // a warp's hidden-chunk columns
  static constexpr int kNT1 = kWH / 8;
  static constexpr int kKS1 = FP >= 64 ? 64 : 32;   // w_in tile rows (<= FP: As's width)
  static constexpr int kKS2 = FP >= 256 ? 16 : 32;  // w_out/w_c tile rows
  static constexpr int kLdA = FP + 4;     // A buffer (c_last chunk, then the sample)
  static constexpr int kLdH = kHC + 4;    // hidden chunk
  static constexpr int kLdW1 = kHC + 8;   // w_in tile
  static constexpr int kLdW2 = FP + 8;    // w_out / w_c tile
  static constexpr int kSlot = kKS1 * kLdW1 > kKS2 * kLdW2 ? kKS1 * kLdW1 : kKS2 * kLdW2;
  static constexpr int kStages = FP >= 512 ? 2 : 3;
  static constexpr int kMinBlocks = FP >= 128 ? 1 : 2;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBM * kLdA + (size_t)kBM * kLdH + (size_t)kStages * kSlot);
  static_assert(kKS1 <= FP && kKS2 <= FP && FP % kKS2 == 0 && kHC % kKS2 == 0,
                "tiles must not reach past the A buffer or a K-chunk");
};

template <int FP>
__global__ void __launch_bounds__(LevelCfg<FP>::kT, LevelCfg<FP>::kMinBlocks)
fused_level_fwd(const float* __restrict__ plane, const float* __restrict__ clast,
                const float* __restrict__ xy, const int* __restrict__ cells,
                const uint8_t* __restrict__ mask, const float* __restrict__ w_in,
                const float* __restrict__ b_in, const float* __restrict__ w_out,
                const float* __restrict__ b_out, const float* __restrict__ w_c,
                const float* __restrict__ b_c, float* __restrict__ plane_out,
                float* __restrict__ c_out, int* __restrict__ counts, int N, int R, int F,
                int Fl, int shift, bool vec_w, bool vec_c) {
  using C = LevelCfg<FP>;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [kBM][kLdA]: c_last chunk, then s
  float* Hs = As + kBM * C::kLdA;               // [kBM][kLdH]: a hidden chunk
  float* ring = Hs + kBM * C::kLdH;             // [kStages][kSlot]: weight tiles

  __shared__ int s_valid[kBM];
  __shared__ int s_cell[kBM];  // row-major cell at this level, -1 if none
  __shared__ Corner s_corner[kBM];
  __shared__ int s_any;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / C::kWQ) * 32;
  const int wq = warp % C::kWQ;
  const int H = 2 * F;
  const long long RR = (long long)R * R;

  if (tid == 0) s_any = 0;
  __syncthreads();
  if (tid < kBM) {
    const int i = i0 + tid;
    int valid = 0, cellr = -1;
    Corner corner = {};
    if (i < N) {
      const long long p = (long long)b * N + i;
      valid = mask[p] != 0;
      corner = bilinear_corner(xy[2 * p], xy[2 * p + 1], R);
      const int c = cells[p];
      if (valid && c >= 0 && (c >> shift) < RR) {
        cellr = morton_to_rowmajor(c >> shift, R);
        atomicAdd(counts + (long long)b * RR + cellr, 1);
      }
      if (valid) s_any = 1;
    }
    s_valid[tid] = valid;
    s_cell[tid] = cellr;
    s_corner[tid] = corner;
  }
  __syncthreads();

  const long long row_b = (long long)b * N + i0;
  const int rows = min(kBM, N - i0);
  if (!s_any) {  // all 64 rows are padding: c_out is exactly 0 there
    for (int e = tid; e < rows * F; e += C::kT) c_out[row_b * F + e] = 0.0f;
    return;
  }

  // The tile sequence: nC tiles of w_c (kKS2 rows each), then per hidden
  // chunk n1 tiles of w_in (kKS1 x kHC) and n2 of w_out (kKS2 x FP).
  const int nC = (Fl + C::kKS2 - 1) / C::kKS2;
  const int n1 = (F + C::kKS1 - 1) / C::kKS1;
  constexpr int n2 = kHC / C::kKS2;
  const int nH = (H + kHC - 1) / kHC;
  const int T = nC + nH * (n1 + n2);
  auto issue = [&](int t) {
    if (t < T) {
      float* slot = ring + (t % C::kStages) * C::kSlot;
      if (t < nC) {
        cp_tile<C::kKS2, FP, C::kT>(slot, C::kLdW2, w_c, F, (long long)t * C::kKS2, Fl, 0, F,
                                    vec_w, tid);
      } else {
        const int u = t - nC;
        const int c = u / (n1 + n2);
        const int v = u - c * (n1 + n2);
        if (v < n1) {
          cp_tile<C::kKS1, kHC, C::kT>(slot, C::kLdW1, w_in, H, v * C::kKS1, F, c * kHC, H,
                                       vec_w, tid);
        } else {
          cp_tile<C::kKS2, FP, C::kT>(slot, C::kLdW2, w_out, F, c * kHC + (v - n1) * C::kKS2,
                                      H, 0, F, vec_w, tid);
        }
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

  float acc[2][C::kNT][4] = {};  // o: rows wm.., columns wq * kWN..
  float hacc[2][C::kNT1][4];     // h chunk: rows wm.., columns wq * kWH..
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) issue(t);
  for (int t = 0; t < T; ++t) {
    int kind, off, c = 0, v = 0;  // kind 0: w_c, 1: w_in, 2: w_out
    if (t < nC) {
      kind = 0;
      const int k = t * C::kKS2;
      off = k % FP;
      if (off == 0) {  // the next K-chunk of c_last -> As (zeros past Fl and N)
        __syncthreads();
        if (vec_c) {
          for (int e = tid; e < kBM * FP / 4; e += C::kT) {
            const int r = e / (FP / 4);
            const int cc = (e - r * (FP / 4)) * 4;
            float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (r < rows && k + cc < Fl)
              x = *reinterpret_cast<const float4*>(clast + (row_b + r) * Fl + k + cc);
            *reinterpret_cast<float4*>(As + r * C::kLdA + cc) = x;
          }
        } else {
          for (int e = tid; e < kBM * FP; e += C::kT) {
            const int r = e / FP;
            const int cc = e - r * FP;
            As[r * C::kLdA + cc] =
                r < rows && k + cc < Fl ? clast[(row_b + r) * Fl + k + cc] : 0.0f;
          }
        }
      }
    } else {
      const int u = t - nC;
      c = u / (n1 + n2);
      v = u - c * (n1 + n2);
      if (v < n1) {
        kind = 1;
        off = v * C::kKS1;
        if (v == 0) {
          if (c == 0) {  // the bilinear sample -> As (zeros past F)
            __syncthreads();
            const float* pl = plane + (long long)b * RR * F;
            for (int e = tid; e < kBM * FP; e += C::kT) {
              const int r = e / FP;
              const int cc = e - r * FP;
              As[r * C::kLdA + cc] = cc < F && r < rows && s_valid[r]
                                         ? bilinear_at(pl, s_corner[r], R, F, cc)
                                         : 0.0f;
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < C::kNT1; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) hacc[mt][nt][i] = 0.0f;
        }
      } else {
        kind = 2;
        off = (v - n1) * C::kKS2;
      }
    }
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t - 1's slot is free
    issue(t + C::kStages - 1);
    const float* W = ring + (t % C::kStages) * C::kSlot;
    if (kind == 0) {
      warp_mma<C::kKS2, C::kNT>(acc, As + off, C::kLdA, W, C::kLdW2, wm, wq * C::kWN, lane);
    } else if (kind == 2) {
      warp_mma<C::kKS2, C::kNT>(acc, Hs + off, C::kLdH, W, C::kLdW2, wm, wq * C::kWN, lane);
    } else {
      warp_mma<C::kKS1, C::kNT1>(hacc, As + off, C::kLdA, W, C::kLdW1, wm, wq * C::kWH, lane);
      if (v == n1 - 1) {  // h chunk c = relu(. + b_in) -> Hs (0 past 2F)
        const int g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < C::kNT1; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = wm + mt * 16 + g + (i >> 1) * 8;
              const int col = wq * C::kWH + nt * 8 + 2 * q + (i & 1);
              const int n = c * kHC + col;
              Hs[r * C::kLdH + col] = n < H ? fmaxf(hacc[mt][nt][i] + b_in[n], 0.0f) : 0.0f;
            }
      }
    }
  }
  cp_async_wait<0>();

  // --- o + b_out + b_c (0 on padding rows) -> c_out; scatter into the plane ------
  float* po = plane_out + (long long)b * RR * F;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + mt * 16 + g + (i >> 1) * 8;
      if (r >= rows) continue;
      const bool valid = s_valid[r] != 0;
      const int cellr = s_cell[r];
      float* crow = c_out + (row_b + r) * F;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        const int n = wq * C::kWN + nt * 8 + 2 * q + (i & 1);
        if (n >= F) continue;
        const float o = valid ? acc[mt][nt][i] + b_out[n] + b_c[n] : 0.0f;
        crow[n] = o;
        if (cellr >= 0) atomicAdd(po + (long long)cellr * F + n, o);
      }
    }
}

template <int FP>
cudaError_t launch_level(const float* plane, const float* clast, const float* xy,
                         const int* cells, const uint8_t* mask, const float* w_in,
                         const float* b_in, const float* w_out, const float* b_out,
                         const float* w_c, const float* b_c, float* plane_out,
                         float* c_out, int* counts, int B, int N, int R, int F, int Fl,
                         int shift, cudaStream_t stream) {
  using C = LevelCfg<FP>;
  cudaError_t err = cudaFuncSetAttribute(
      fused_level_fwd<FP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const bool vec_w = F % 4 == 0 && aligned16(w_in) && aligned16(w_out) && aligned16(w_c);
  const bool vec_c = Fl % 4 == 0 && aligned16(clast);
  const dim3 grid((N + kBM - 1) / kBM, B);
  fused_level_fwd<FP><<<grid, C::kT, C::kSmem, stream>>>(
      plane, clast, xy, cells, mask, w_in, b_in, w_out, b_out, w_c, b_c, plane_out, c_out,
      counts, N, R, F, Fl, shift, vec_w, vec_c);
  return cudaGetLastError();
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// plane (B,R,R,F) NHWC, c_last (B,N,Fl), xy (B,N,2), cells (B,N) finest Morton
// ids, mask (B,N) u8; weights row-major (in, out): w_in (F,2F), w_out (2F,F),
// w_c (Fl,F) -> plane_out (B,R,R,F) scatter-mean (empty cells 0), c_out
// (B,N,F) (0 on padding rows), counts (B,R,R) i32. F <= 512; any Fl.
int t2h_fused_level(const float* plane, const float* clast, const float* xy,
                    const int* cells, const uint8_t* mask, const float* w_in,
                    const float* b_in, const float* w_out, const float* b_out,
                    const float* w_c, const float* b_c, float* plane_out,
                    float* c_out, int* counts, int B, int N, int R, int F, int Fl,
                    int shift, cudaStream_t stream) {
  const long long nc = (long long)B * R * R;
  const long long nv = nc * F;
  if (nv > 0) {
    fill_f32<<<grid_for(nv), kThreads, 0, stream>>>(plane_out, nv, 0.0f);
    fill_i32<<<grid_for(nc), kThreads, 0, stream>>>(counts, nc, 0);
  }
  if ((long long)B * N > 0) {
    const int fp = F <= 32 ? 32 : F <= 64 ? 64 : F <= 128 ? 128 : F <= 256 ? 256 : 512;
    if (F > 512) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
#define T2H_LEVEL(FP)                                                                   \
  case FP:                                                                              \
    err = launch_level<FP>(plane, clast, xy, cells, mask, w_in, b_in, w_out, b_out, w_c, \
                           b_c, plane_out, c_out, counts, B, N, R, F, Fl, shift, stream); \
    break;
    switch (fp) {
      T2H_LEVEL(32)
      T2H_LEVEL(64)
      T2H_LEVEL(128)
      T2H_LEVEL(256)
      default:
      T2H_LEVEL(512)
    }
#undef T2H_LEVEL
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nv > 0)
    divide_by_counts<<<grid_for(nv), kThreads, 0, stream>>>(plane_out, counts, nv, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
