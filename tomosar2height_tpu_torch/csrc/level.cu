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
// chunk. Here a block owns 32 consecutive points and keeps everything for
// them in shared memory: the sampled features (k-major), the hidden layer
// (k-major) and two staged 32x128 tiles of whichever weight matrix it is
// contracting (double-buffered: the next tile's loads fly during the current
// tile's FMAs; the block GEMM is in tile_gemm.cuh); c_last reuses the
// sample's space once the hidden layer exists.
// Each of the 256 threads holds a 4-point x 4-column fp32 accumulator tile of
// a 32x128 output slab; a warp owns 16 columns of all 32 points. The plane scatter is an atomicAdd per output element
// into a zeroed (B,R,R,F) buffer, then a finalize pass divides by the counts.
//
// Bound on the H100: fp32 FMAs of the three matmuls, ~1.9M MAC per point per
// forward summed over the eight levels (the 32^2 level with F=512 alone is
// 1.2M); the plane traffic is small beside it. The inner loop issues two
// 16-byte shared loads per 16 FMAs, two shared wavefronts per warp; at F=512 one block fills 224 KB of shared
// memory, so one block runs per SM. Blocks whose 32 rows are all padding
// write zeros to c_out and skip the matmuls. Tensor cores (wgmma) and TMA
// staging are left for later work.

#include <algorithm>

#include "common.cuh"
#include "tile_gemm.cuh"

namespace t2h {

size_t level_smem_bytes(int F, int Fl) {
  const int ka = std::max(F, Fl);
  return sizeof(float) *
         ((size_t)ka * kP + (size_t)2 * F * kP + (size_t)2 * kKT * kNT);
}

__global__ void __launch_bounds__(kThreads)
fused_level_fwd(const float* __restrict__ plane, const float* __restrict__ clast,
                const float* __restrict__ xy, const int* __restrict__ cells,
                const uint8_t* __restrict__ mask, const float* __restrict__ w_in,
                const float* __restrict__ b_in, const float* __restrict__ w_out,
                const float* __restrict__ b_out, const float* __restrict__ w_c,
                const float* __restrict__ b_c, float* __restrict__ plane_out,
                float* __restrict__ c_out, int* __restrict__ counts, int N, int R,
                int F, int Fl, int shift) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kP;
  const int tid = threadIdx.x;
  // warp w owns output columns [16w, 16w + 16) of a 128-column pass for all
  // 32 rows; lane = 8 row groups x 4 column groups of 4x4. A warp's shared
  // reads per step are then 128 B of A and 64 B of W (2 wavefronts).
  const int lane = tid & 31;
  const int row0 = 4 * (lane & 7);
  const int col0 = 16 * (tid >> 5) + 4 * (lane >> 3);
  const int H = 2 * F;
  const int ka = max(F, Fl);
  float* A = reinterpret_cast<float*>(smem4);  // [ka][kP]: sample, then c_last
  float* Hs = A + (size_t)ka * kP;             // [H][kP]: hidden layer
  float* Ws = Hs + (size_t)H * kP;             // [2][kKT][kNT]: staged weights

  __shared__ int s_valid[kP];
  __shared__ int s_cell[kP];  // row-major cell at this level, -1 if none
  __shared__ int s_base[kP];  // y0 * R + x0
  __shared__ int s_dx[kP];    // pixel offset of the x+1 neighbour (0 at the edge)
  __shared__ int s_dy[kP];    // pixel offset of the y+1 neighbour (0 at the edge)
  __shared__ float s_wx[kP];
  __shared__ float s_wy[kP];
  __shared__ int s_any;

  const long long RR = (long long)R * R;
  if (tid == 0) s_any = 0;
  __syncthreads();
  if (tid < kP) {
    const int i = i0 + tid;
    int valid = 0, cellr = -1, base = 0, dx = 0, dy = 0;
    float wx = 0.0f, wy = 0.0f;
    if (i < N) {
      const long long p = (long long)b * N + i;
      valid = mask[p] != 0;
      const float rmax = static_cast<float>(R - 1);
      const float x = fminf(fmaxf(xy[2 * p] * rmax, 0.0f), rmax);
      const float y = fminf(fmaxf(xy[2 * p + 1] * rmax, 0.0f), rmax);
      const int x0 = min(max(static_cast<int>(floorf(x)), 0), R - 1);
      const int y0 = min(max(static_cast<int>(floorf(y)), 0), R - 1);
      wx = x - static_cast<float>(x0);
      wy = y - static_cast<float>(y0);
      dx = x0 + 1 < R ? 1 : 0;
      dy = y0 + 1 < R ? R : 0;
      base = y0 * R + x0;
      const int c = cells[p];
      if (valid && c >= 0 && (c >> shift) < RR) {
        cellr = morton_to_rowmajor(c >> shift, R);
        atomicAdd(counts + (long long)b * RR + cellr, 1);
      }
      if (valid) s_any = 1;
    }
    s_valid[tid] = valid;
    s_cell[tid] = cellr;
    s_base[tid] = base;
    s_dx[tid] = dx;
    s_dy[tid] = dy;
    s_wx[tid] = wx;
    s_wy[tid] = wy;
  }
  __syncthreads();

  if (!s_any) {  // all 32 rows are padding: c_out is exactly 0 there
    for (int e = tid; e < kP * F; e += kThreads) {
      const int r = e / F;
      if (i0 + r < N) c_out[((long long)b * N + i0 + r) * F + (e - r * F)] = 0.0f;
    }
    return;
  }

  // --- bilinear sample -> A[c][r] ---------------------------------------------
  const float* pl = plane + (long long)b * RR * F;
  for (int e = tid; e < kP * F; e += kThreads) {
    const int r = e / F;
    const int c = e - r * F;
    float v = 0.0f;
    if (i0 + r < N && s_valid[r]) {
      const long long o = (long long)s_base[r] * F + c;
      const long long ox = (long long)s_dx[r] * F;
      const long long oy = (long long)s_dy[r] * F;
      const float wx = s_wx[r], wy = s_wy[r];
      const float top = pl[o] * (1.0f - wx) + pl[o + ox] * wx;
      const float bot = pl[o + oy] * (1.0f - wx) + pl[o + oy + ox] * wx;
      v = top * (1.0f - wy) + bot * wy;
    }
    A[c * kP + r] = v;
  }
  __syncthreads();

  // --- h = relu(s @ w_in + b_in) -> Hs[n][r] ------------------------------------
  for (int n0 = 0; n0 < H; n0 += kNT) {
    float acc[4][4] = {};
    gemm_tile(acc, A, F, w_in, H, n0, Ws, tid, row0, col0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + col0 + j;
      if (n < H) {
        const float bias = b_in[n];
        float4 h;
        h.x = fmaxf(acc[0][j] + bias, 0.0f);
        h.y = fmaxf(acc[1][j] + bias, 0.0f);
        h.z = fmaxf(acc[2][j] + bias, 0.0f);
        h.w = fmaxf(acc[3][j] + bias, 0.0f);
        *reinterpret_cast<float4*>(Hs + n * kP + row0) = h;
      }
    }
  }

  // --- c_last -> A[k][r] (the sample is no longer needed) ----------------------
  for (int e = tid; e < kP * Fl; e += kThreads) {
    const int r = e / Fl;
    const int k = e - r * Fl;
    A[k * kP + r] =
        i0 + r < N ? clast[((long long)b * N + i0 + r) * Fl + k] : 0.0f;
  }
  __syncthreads();

  // --- o = h @ w_out + c_last @ w_c + b_out + b_c; write c_out; scatter ------------
  float* po = plane_out + (long long)b * RR * F;
  for (int n0 = 0; n0 < F; n0 += kNT) {
    float acc[4][4] = {};
    gemm_tile(acc, Hs, H, w_out, F, n0, Ws, tid, row0, col0);
    gemm_tile(acc, A, Fl, w_c, F, n0, Ws, tid, row0, col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
      if (i0 + r >= N) continue;
      const int cellr = s_cell[r];
      const bool valid = s_valid[r] != 0;
      float* crow = c_out + ((long long)b * N + i0 + r) * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col0 + j;
        if (n >= F) continue;
        const float o = valid ? acc[i][j] + b_out[n] + b_c[n] : 0.0f;
        crow[n] = o;
        if (cellr >= 0) atomicAdd(po + (long long)cellr * F + n, o);
      }
    }
  }
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// plane (B,R,R,F) NHWC, c_last (B,N,Fl), xy (B,N,2), cells (B,N) finest Morton
// ids, mask (B,N) u8; weights row-major (in, out): w_in (F,2F), w_out (2F,F),
// w_c (Fl,F) -> plane_out (B,R,R,F) scatter-mean (empty cells 0), c_out
// (B,N,F) (0 on padding rows), counts (B,R,R) i32.
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
    const size_t smem = level_smem_bytes(F, Fl);
    cudaError_t err = cudaFuncSetAttribute(
        fused_level_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kP - 1) / kP, B);
    fused_level_fwd<<<grid, kThreads, smem, stream>>>(
        plane, clast, xy, cells, mask, w_in, b_in, w_out, b_out, w_c, b_c,
        plane_out, c_out, counts, N, R, F, Fl, shift);
  }
  if (nv > 0)
    divide_by_counts<<<grid_for(nv), kThreads, 0, stream>>>(plane_out, counts, nv, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
