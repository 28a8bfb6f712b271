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
// 2. t2h_level_bwd_reduce (atb_tf32x3 + sum_splits), three calls: each
//    weight gradient is A^T B over all M rows, split-K on the tensor cores
//    at fp32 accuracy (3xTF32 mma.sync, mma_tf32x3.cuh): a block owns one
//    128 x 128 output tile (64 where Ka or Nb is 64 or less) and one
//    contiguous row split, its rows streamed through a 3-stage cp.async
//    ring of 32-row steps; the blocks of the first k-tile also sum the
//    columns of the B tiles they hold (the bias gradient), and a second pass
//    sums the splits in a fixed order. No atomics: the weight gradients are
//    deterministic, bit-equal run to run; d_plane is order-dependent (~1e-7
//    relative) as K3/K4's sums are.
//
// Bound on the H100: the MACs. A row costs 10F^2 + 2F*Fl MAC (6F^2 + F*Fl in
// phase 1 on fp32 FMAs, 4F^2 + F*Fl in phase 2 on the tensor cores, three
// TF32 products each), ~2.9M at the F=512 level, 2.4x K4's forward. Phase
// 2's scratch rows are read once per output-tile column or row (128-wide
// tiles: 4-8 times at F=512, mostly from L2, since the blocks of one split
// run side by side). Shared memory per phase-1 block:
// 4 * 32 * 3F + 32 KB of staging, 224 KB at F=512, so one block per SM, as
// K4 was; it does not grow with Fl (d_c_last leaves each 128-column pass
// from registers), so the Fl = 1024 level of a depth-6 U-Net fits as it is.
// The row pass keeps fp32 FMAs (tile_gemm.cuh).

#include <algorithm>

#include "bilinear.cuh"
#include "common.cuh"
#include "mma_tf32x3.cuh"
#include "tile_gemm.cuh"

namespace t2h {

constexpr int kRM = 32;      // rows per reduction step
constexpr int kRStages = 3;  // reduction steps in flight

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
atb_tf32x3(const float* __restrict__ A, const float* __restrict__ Bm, long long M, int Ka,
           int Nb, long long rows_per_split, int Kout, bool vec_a, bool vec_b,
           float* __restrict__ part) {
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
    // the step's four k8 steps chain in the tensor cores into tmp, which
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
      atb_tf32x3<BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const long long rps = ((long long)M + splits - 1) / splits;
  const dim3 grid((Nb + BN - 1) / BN, (Ka + BK - 1) / BK, splits);
  const bool vec_a = Ka % 4 == 0 && aligned16(A);
  const bool vec_b = Nb % 4 == 0 && aligned16(Bm);
  atb_tf32x3<BK, BN><<<grid, kRThreads, T::kSmem, stream>>>(A, Bm, M, Ka, Nb, rps, Kout,
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

// The side of a reduction's output tile along a gradient side of n: 128, or
// 64 where n is 64 or less.
static int reduce_tile(int n) { return n > 64 ? 128 : 64; }

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

}  // extern "C"
