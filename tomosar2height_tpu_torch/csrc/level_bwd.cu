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
// card run in parallel and in no order, so the work is split in two phases:
//
// 1. fused_level_bwd_rows: a block owns 32 consecutive rows, as in K4, and
//    keeps them in shared memory: X [F][32] holds the sample, then d_o; Hs
//    [2F][32] holds h, then d_h in place (h > 0 <=> pre > 0). Four block GEMMs
//    (tile_gemm.cuh) give pre, d_c_last, d_h and d_s. The rows' s, h, d_o and
//    d_h go to scratch (M x 6F floats, M = B*N rows) for phase 2. d_plane is a
//    scatter of d_s through the four bilinear weights: where the block's
//    points touch at most 32 pixels (Morton-sorted rows at R <= 64), they are
//    summed in shared memory first (X is free by then) and flushed with one
//    global atomic per touched (pixel, channel) -- the CUDA form of the TPU
//    kernel's per-tile halo window; else each corner is a global atomicAdd.
// 2. t2h_level_bwd_reduce (atb_partial + sum_splits), three calls: each
//    weight gradient is A^T B over all M rows, a hand-written tiled fp32
//    reduction: a block owns one 64 x 64 output tile and one contiguous row
//    split (split-K), an extra all-ones column of A gives the bias gradient,
//    and a second pass sums the splits in a fixed order. No atomics: the
//    weight gradients are deterministic; d_plane is order-dependent (~1e-7
//    relative) as K3/K4's sums are.
//
// Bound on the H100: fp32 FMAs. A row costs 10F^2 + 2F*Fl MAC (6F^2 + F*Fl in
// phase 1, 4F^2 + F*Fl in phase 2), ~2.9M at the F=512 level, 2.4x K4's
// forward; the scratch traffic (6F floats written, read back once per
// output-tile column) is small beside it. Shared memory per phase-1 block:
// 4 * 32 * 3F + 32 KB of staging, 224 KB at F=512, so one block per SM, as
// K4; it does not grow with Fl (d_c_last leaves each 128-column pass from
// registers), so the Fl = 1024 level of a depth-6 U-Net fits as it is.
// Tensor cores (wgmma) and TMA staging are left for later work.

#include <algorithm>

#include "bilinear.cuh"
#include "common.cuh"
#include "tile_gemm.cuh"

namespace t2h {

constexpr int kRT = 64;  // reduction output tile side (rows of A^T and cols of B)
constexpr int kRM = 32;  // rows per reduction step

size_t level_bwd_smem_bytes(int F) {
  return sizeof(float) * ((size_t)3 * F * kP + (size_t)2 * kKT * kNT);
}

__global__ void __launch_bounds__(kThreads)
fused_level_bwd_rows(const float* __restrict__ plane, const float* __restrict__ xy,
                     const int* __restrict__ cells, const uint8_t* __restrict__ mask,
                     const int* __restrict__ counts, const float* __restrict__ g_plane,
                     const float* __restrict__ g_c, const float* __restrict__ w_in,
                     const float* __restrict__ b_in, const float* __restrict__ w_out_t,
                     const float* __restrict__ w_c_t, const float* __restrict__ w_in_t,
                     float* __restrict__ d_plane, float* __restrict__ d_clast,
                     float* __restrict__ s_buf, float* __restrict__ h_buf,
                     float* __restrict__ do_buf, float* __restrict__ dh_buf, int N,
                     int R, int F, int Fl, int shift) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = 4 * (lane & 7);
  const int col0 = 16 * (tid >> 5) + 4 * (lane >> 3);
  const int H = 2 * F;
  float* X = reinterpret_cast<float*>(smem4);  // [F][kP]: sample, d_o, d_plane window
  float* Hs = X + (size_t)F * kP;              // [H][kP]: h, then d_h
  float* Ws = Hs + (size_t)H * kP;             // [2][kKT][kNT]: staged weights

  __shared__ int s_valid[kP];
  __shared__ int s_cell[kP];  // row-major cell at this level, -1 if none
  __shared__ int s_x0[kP];
  __shared__ int s_y0[kP];
  __shared__ int s_dx[kP];    // 1 if the x+1 neighbour is inside the plane
  __shared__ int s_dy[kP];
  __shared__ float s_wx[kP];
  __shared__ float s_wy[kP];
  __shared__ float s_cnt[kP];  // max(count, 1) of the row's cell
  __shared__ int s_any, s_xmin, s_xmax, s_ymin, s_ymax;

  const long long RR = (long long)R * R;
  if (tid == 0) {
    s_any = 0;
    s_xmin = s_ymin = R;
    s_xmax = s_ymax = -1;
  }
  __syncthreads();
  if (tid < kP) {
    const int i = i0 + tid;
    int valid = 0, cellr = -1, x0 = 0, y0 = 0, dx = 0, dy = 0;
    float wx = 0.0f, wy = 0.0f, cnt = 1.0f;
    if (i < N) {
      const long long p = (long long)b * N + i;
      valid = mask[p] != 0;
      if (valid) {
        const Corner corner = bilinear_corner(xy[2 * p], xy[2 * p + 1], R);
        x0 = corner.x0;
        y0 = corner.y0;
        dx = corner.dx;
        dy = corner.dy;
        wx = corner.wx;
        wy = corner.wy;
        const int c = cells[p];
        if (c >= 0 && (c >> shift) < RR) {
          cellr = morton_to_rowmajor(c >> shift, R);
          const int n = counts[(long long)b * RR + cellr];
          cnt = static_cast<float>(n > 1 ? n : 1);
        }
        s_any = 1;
        atomicMin(&s_xmin, x0);
        atomicMax(&s_xmax, x0 + dx);
        atomicMin(&s_ymin, y0);
        atomicMax(&s_ymax, y0 + dy);
      }
    }
    s_valid[tid] = valid;
    s_cell[tid] = cellr;
    s_x0[tid] = x0;
    s_y0[tid] = y0;
    s_dx[tid] = dx;
    s_dy[tid] = dy;
    s_wx[tid] = wx;
    s_wy[tid] = wy;
    s_cnt[tid] = cnt;
  }
  __syncthreads();

  const long long rowb = (long long)b * N + i0;  // global row of the block's row 0
  if (!s_any) {  // all 32 rows are padding: every output and scratch row is 0
    for (int e = tid; e < kP * H; e += kThreads) {
      const int r = e / H;
      if (i0 + r >= N) continue;
      const int c = e - r * H;
      h_buf[(rowb + r) * H + c] = 0.0f;
      dh_buf[(rowb + r) * H + c] = 0.0f;
      if (c < F) {
        s_buf[(rowb + r) * F + c] = 0.0f;
        do_buf[(rowb + r) * F + c] = 0.0f;
      }
    }
    for (int e = tid; e < kP * Fl; e += kThreads) {
      const int r = e / Fl;
      if (i0 + r < N) d_clast[(rowb + r) * Fl + (e - r * Fl)] = 0.0f;
    }
    return;
  }

  // --- recompute the bilinear sample -> X[c][r], scratch s ----------------------
  const float* pl = plane + (long long)b * RR * F;
  for (int e = tid; e < kP * F; e += kThreads) {
    const int r = e / F;
    const int c = e - r * F;
    float v = 0.0f;
    if (s_valid[r]) {
      const Corner corner = {s_x0[r], s_y0[r], s_dx[r], s_dy[r], s_wx[r], s_wy[r]};
      v = bilinear_at(pl, corner, R, F, c);
    }
    X[c * kP + r] = v;
    if (i0 + r < N) s_buf[(rowb + r) * F + c] = v;
  }
  __syncthreads();

  // --- h = relu(s @ w_in + b_in) -> Hs[n][r], scratch h --------------------------
  for (int n0 = 0; n0 < H; n0 += kNT) {
    float acc[4][4] = {};
    gemm_tile(acc, X, F, w_in, H, n0, Ws, tid, row0, col0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + col0 + j;
      if (n >= H) continue;
      const float bias = b_in[n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = fmaxf(acc[i][j] + bias, 0.0f);
        Hs[n * kP + row0 + i] = h;
        if (i0 + row0 + i < N) h_buf[(rowb + row0 + i) * H + n] = h;
      }
    }
  }

  // --- d_o = (g_c + g_plane[cell] / count) * valid -> X[c][r], scratch d_o ------
  // (the last gemm_tile ended with a barrier: nothing reads the sample now)
  const float* gp = g_plane + (long long)b * RR * F;
  for (int e = tid; e < kP * F; e += kThreads) {
    const int r = e / F;
    const int c = e - r * F;
    float v = 0.0f;
    if (s_valid[r]) {
      v = g_c[(rowb + r) * F + c];
      if (s_cell[r] >= 0) v += gp[(long long)s_cell[r] * F + c] / s_cnt[r];
    }
    X[c * kP + r] = v;
    if (i0 + r < N) do_buf[(rowb + r) * F + c] = v;
  }
  __syncthreads();

  // --- d_c_last = d_o @ w_c^T ---------------------------------------------------
  for (int n0 = 0; n0 < Fl; n0 += kNT) {
    float acc[4][4] = {};
    gemm_tile(acc, X, F, w_c_t, Fl, n0, Ws, tid, row0, col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i0 + row0 + i >= N) continue;
      float* crow = d_clast + (rowb + row0 + i) * Fl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col0 + j;
        if (n < Fl) crow[n] = acc[i][j];
      }
    }
  }

  // --- d_h = (d_o @ w_out^T) * [h > 0] -> Hs in place, scratch d_h --------------
  // (each thread rewrites only the Hs elements it alone reads)
  for (int n0 = 0; n0 < H; n0 += kNT) {
    float acc[4][4] = {};
    gemm_tile(acc, X, F, w_out_t, H, n0, Ws, tid, row0, col0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + col0 + j;
      if (n >= H) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* hp = Hs + n * kP + row0 + i;
        const float d = *hp > 0.0f ? acc[i][j] : 0.0f;
        *hp = d;
        if (i0 + row0 + i < N) dh_buf[(rowb + row0 + i) * H + n] = d;
      }
    }
  }

  // --- d_s = d_h @ w_in^T, scattered through the bilinear weights ----------------
  const int xmin = s_xmin, ymin = s_ymin;
  const int ww = s_xmax - xmin + 1;
  const int area = ww * (s_ymax - ymin + 1);
  const bool local = area <= kP;  // the window fits X ([area][F] <= [kP][F])
  __syncthreads();                // d_h complete in Hs
  if (local)
    for (int e = tid; e < area * F; e += kThreads) X[e] = 0.0f;
  __syncthreads();
  float* dp = d_plane + (long long)b * RR * F;
  for (int n0 = 0; n0 < F; n0 += kNT) {
    float acc[4][4] = {};
    gemm_tile(acc, Hs, H, w_in_t, F, n0, Ws, tid, row0, col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
      if (!s_valid[r]) continue;
      const int x0 = s_x0[r], y0 = s_y0[r];
      const int px[4] = {x0, x0 + s_dx[r], x0, x0 + s_dx[r]};
      const int py[4] = {y0, y0, y0 + s_dy[r], y0 + s_dy[r]};
      const float wx = s_wx[r], wy = s_wy[r];
      const float wk[4] = {(1.0f - wx) * (1.0f - wy), wx * (1.0f - wy),
                           (1.0f - wx) * wy, wx * wy};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col0 + j;
        if (n >= F) continue;
        const float v = acc[i][j];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (wk[q] == 0.0f) continue;
          if (local) {
            atomicAdd(X + ((py[q] - ymin) * ww + (px[q] - xmin)) * F + n, wk[q] * v);
          } else {
            atomicAdd(dp + ((long long)py[q] * R + px[q]) * F + n, wk[q] * v);
          }
        }
      }
    }
  }
  if (local) {
    __syncthreads();
    for (int e = tid; e < area * F; e += kThreads) {
      const float v = X[e];
      if (v == 0.0f) continue;
      const int q = e / F;
      const int y = ymin + q / ww;
      const int x = xmin + q % ww;
      atomicAdd(dp + ((long long)y * R + x) * F + (e - q * F), v);
    }
  }
}

// part[split][k][n] = sum over the split's rows m of A'[m][k] * Bm[m][n],
// where A' is A (M x Ka) with column Ka all ones when Kout == Ka + 1 (the
// bias gradient, colsum of Bm). Block: one kRT x kRT output tile, one split.
__global__ void __launch_bounds__(kThreads)
atb_partial(const float* __restrict__ A, const float* __restrict__ Bm, long long M,
            int Ka, int Kout, int Nb, long long rows_per_split, float* __restrict__ part) {
  __shared__ __align__(16) float As[kRM][kRT];
  __shared__ __align__(16) float Bs[kRM][kRT];
  const int n0 = blockIdx.x * kRT;
  const int k0 = blockIdx.y * kRT;
  const long long m_begin = blockIdx.z * rows_per_split;
  const long long m_end = min(M, m_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 16 x 16 threads, 4 x 4 outputs each
  const int tx = tid & 15;
  float acc[4][4] = {};
  for (long long m0 = m_begin; m0 < m_end; m0 += kRM) {
    for (int e = tid; e < kRM * kRT; e += kThreads) {
      const int r = e / kRT;
      const int c = e - r * kRT;
      const long long m = m0 + r;
      const int k = k0 + c;
      const int n = n0 + c;
      float a = 0.0f, bv = 0.0f;
      if (m < m_end) {
        if (k < Ka) {
          a = A[m * Ka + k];
        } else if (k < Kout) {
          a = 1.0f;
        }
        if (n < Nb) bv = Bm[m * Nb + n];
      }
      As[r][c] = a;
      Bs[r][c] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kRM; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * Kout * Nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= Kout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Nb) out[(long long)k * Nb + n] = acc[i][j];
    }
  }
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

}  // namespace t2h

using namespace t2h;

extern "C" {

// Phase 1. Inputs as K4's (plane (B,R,R,F) NHWC, c_last (B,N,Fl), xy (B,N,2),
// cells (B,N) finest Morton ids, mask (B,N) u8) plus K4's counts (B,R,R) i32
// and the cotangents g_plane (B,R,R,F), g_c (B,N,F). Weights row-major: w_in
// (F,2F), b_in (2F), and the transposes w_out_t (F,2F), w_c_t (F,Fl), w_in_t
// (2F,F). Outputs: d_plane (B,R,R,F), d_clast (B,N,Fl), and the rows for
// phase 2: s_buf (B*N,F), h_buf (B*N,2F), do_buf (B*N,F), dh_buf (B*N,2F).
int t2h_fused_level_bwd(const float* plane, const float* xy, const int* cells,
                        const uint8_t* mask, const int* counts, const float* g_plane,
                        const float* g_c, const float* w_in, const float* b_in,
                        const float* w_out_t, const float* w_c_t, const float* w_in_t,
                        float* d_plane, float* d_clast, float* s_buf, float* h_buf,
                        float* do_buf, float* dh_buf, int B, int N, int R, int F,
                        int Fl, int shift, cudaStream_t stream) {
  const long long nv = (long long)B * R * R * F;
  if (nv > 0) fill_f32<<<grid_for(nv), kThreads, 0, stream>>>(d_plane, nv, 0.0f);
  if ((long long)B * N > 0) {
    const size_t smem = level_bwd_smem_bytes(F);
    cudaError_t err = cudaFuncSetAttribute(
        fused_level_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kP - 1) / kP, B);
    fused_level_bwd_rows<<<grid, kThreads, smem, stream>>>(
        plane, xy, cells, mask, counts, g_plane, g_c, w_in, b_in, w_out_t, w_c_t,
        w_in_t, d_plane, d_clast, s_buf, h_buf, do_buf, dh_buf, N, R, F, Fl, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// Phase 2, one weight gradient: A (M,Ka), Bm (M,Nb) -> dw = A^T Bm (Ka,Nb)
// and, when db is not null, db = colsum(Bm) (Nb). part: splits * (Ka+1) * Nb
// floats of scratch.
int t2h_level_bwd_reduce(const float* A, const float* Bm, int M, int Ka, int Nb,
                         int splits, float* part, float* dw, float* db,
                         cudaStream_t stream) {
  const int Kout = db != nullptr ? Ka + 1 : Ka;
  const long long rps = ((long long)M + splits - 1) / splits;
  const dim3 grid((Nb + kRT - 1) / kRT, (Kout + kRT - 1) / kRT, splits);
  atb_partial<<<grid, kThreads, 0, stream>>>(A, Bm, M, Ka, Kout, Nb, rps, part);
  sum_splits<<<grid_for((long long)Kout * Nb), kThreads, 0, stream>>>(part, splits, Ka,
                                                                      Kout, Nb, dw, db);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
