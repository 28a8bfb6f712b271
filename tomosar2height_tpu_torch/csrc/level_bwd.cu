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
// 1. fused_level_bwd_rows: a block owns kRB = 64 consecutive rows, and its
//    four contractions run on the tensor cores at fp32 accuracy (3xTF32
//    mma.sync, mma_tf32x3.cuh; K4's warp layout and chain-length rule). The
//    shared A buffer [64][F] holds the sample s, then d_o, then the d_plane
//    window. In order, each weight tile arriving through one cp.async ring:
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
//    The rows' s, h, d_o and d_h go to scratch (M x 6F floats, M = B*N
//    rows) for phase 2. d_plane is a scatter of d_s through the four
//    bilinear weights: the block lists the distinct pixels its rows'
//    corners touch (a shared hash table), groups the corners by pixel (a
//    counting sort), and a thread per (pixel, channel) sums that pixel's
//    shares of d_s (staged in the A buffer) and adds them to d_plane with
//    one global atomic -- the CUDA form of the TPU kernel's per-tile halo
//    window. Morton-sorted rows at the coarse levels share pixels (a
//    block's 256 corners touch a median 16 pixels at R = 32, 33 at 64, 82
//    at 128 on the flagship's points), so the atomics fall 3-16x there, and
//    no float atomics go to shared memory.
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

#include <algorithm>

#include "bilinear.cuh"
#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace t2h {

constexpr int kRM = 32;      // rows per reduction step
constexpr int kRStages = 3;  // reduction steps in flight

constexpr int kRB = 64;     // rows per row-pass block
constexpr int kHash = 256;  // buckets of a block's pixel table
static_assert(4 * kRB <= kHash, "every corner of the block's rows has a bucket");
constexpr int kRHC = 64;  // hidden columns per chunk

// Per width class FP (F rounded up to a power of two >= 32), K4's layout
// (level.cu LevelCfg): 512 threads at F = 128 and 512 (128 registers), 256
// threads at the others (two blocks an SM at F <= 64); warps are 2 row
// halves x kWQ column groups, of d_c_last / d_s and of the hidden chunk
// alike. Each thread keeps kGate gate bits per hidden chunk (its elements
// of the chunk), packed in kGateWords words of shared memory.
template <int FP>
struct RowCfg {
  static constexpr int kT = FP == 128 || FP == 512 ? 512 : 256;
  static constexpr int kWQ = kT / 64;
  static constexpr int kWN = FP / kWQ;  // a warp's d_s / d_c_last columns
  static constexpr int kNT = kWN / 8;
  static constexpr int kWH = kRHC / kWQ;  // a warp's hidden-chunk columns
  static constexpr int kNT1 = kWH / 8;
  static constexpr int kKS1 = FP >= 64 ? 64 : 32;   // w_in / w_out^T tile rows
  static constexpr int kKS2 = FP >= 256 ? 16 : 32;  // w_c^T / w_in^T tile rows
  static constexpr int kLdA = FP + 4;     // A buffer: s, then d_o
  static constexpr int kLdH = kRHC + 4;   // d_h chunk
  static constexpr int kLdW1 = kRHC + 8;  // w_in / w_out^T tile
  static constexpr int kLdW2 = FP + 8;    // w_c^T / w_in^T tile
  static constexpr int kSlot = kKS1 * kLdW1 > kKS2 * kLdW2 ? kKS1 * kLdW1 : kKS2 * kLdW2;
  static constexpr int kStages = FP >= 512 ? 2 : 3;
  static constexpr int kMinBlocks = FP >= 128 ? 1 : 2;
  static constexpr int kGate = 2 * kNT1 * 4;
  static constexpr int kGateWords = (2 * FP / kRHC * kGate + 31) / 32;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kRB * kLdA + (size_t)kRB * kLdH + (size_t)kStages * kSlot) +
      sizeof(uint32_t) * (size_t)kGateWords * kT;
  static_assert(kKS1 <= FP && FP % kKS1 == 0 && kKS2 <= FP && FP % kKS2 == 0 &&
                    kRHC % kKS2 == 0 && 32 % kGate == 0,
                "tiles must not reach past the A buffer or a chunk");
};

template <int FP>
__global__ void __launch_bounds__(RowCfg<FP>::kT, RowCfg<FP>::kMinBlocks)
fused_level_bwd_rows(const float* __restrict__ plane, const float* __restrict__ xy,
                     const int* __restrict__ cells, const uint8_t* __restrict__ mask,
                     const int* __restrict__ counts, const float* __restrict__ g_plane,
                     const float* __restrict__ g_c, const float* __restrict__ w_in,
                     const float* __restrict__ b_in, const float* __restrict__ w_out_t,
                     const float* __restrict__ w_c_t, const float* __restrict__ w_in_t,
                     float* __restrict__ d_plane, float* __restrict__ d_clast,
                     float* __restrict__ s_buf, float* __restrict__ h_buf,
                     float* __restrict__ do_buf, float* __restrict__ dh_buf, int N,
                     int R, int F, int Fl, int shift, bool vec_h, bool vec_f, bool vec_l) {
  using C = RowCfg<FP>;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [kRB][kLdA]: s, d_o, d_plane window
  float* Hs = As + kRB * C::kLdA;               // [kRB][kLdH]: a d_h chunk
  float* ring = Hs + kRB * C::kLdH;             // [kStages][kSlot]: weight tiles
  uint32_t* gate = reinterpret_cast<uint32_t*>(ring + C::kStages * C::kSlot);  // [words][kT]

  __shared__ int s_valid[kRB];
  __shared__ int s_cell[kRB];  // row-major cell at this level, -1 if none
  __shared__ Corner s_corner[kRB];
  __shared__ float s_cnt[kRB];  // max(count, 1) of the row's cell
  // d_plane's scatter: the distinct pixels the rows' corners touch (an
  // open-addressing table of pixel ids, then of their slots), (row, corner)
  // -> bucket; slot -> pixel;
  // the slots' first corners in s_first (slot order), the corners (row *
  // 4 + corner) grouped by slot in s_corners
  __shared__ int s_key[kHash];
  __shared__ int s_bucket[4 * kRB];
  __shared__ int s_pix[4 * kRB];
  __shared__ int s_first[4 * kRB + 1];
  __shared__ int s_corners[4 * kRB];
  __shared__ int s_any, s_nslot;

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

  if (tid == 0) {
    s_any = 0;
    s_nslot = 0;
  }
  for (int e = tid; e < kHash; e += C::kT) s_key[e] = -1;
  for (int e = tid; e <= 4 * kRB; e += C::kT) s_first[e] = 0;
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
      h_buf[rowb * H + e] = 0.0f;
      dh_buf[rowb * H + e] = 0.0f;
    }
    for (int e = tid; e < rows * F; e += C::kT) {
      s_buf[rowb * F + e] = 0.0f;
      do_buf[rowb * F + e] = 0.0f;
    }
    for (int e = tid; e < rows * Fl; e += C::kT) d_clast[rowb * Fl + e] = 0.0f;
    return;
  }

  // --- the distinct pixels of the rows' corners, each a slot of the window -----
  if (tid < kRB * 4) {
    const int r = tid >> 2, k = tid & 3;
    int h = -1;
    if (s_valid[r]) {
      const Corner cr = s_corner[r];
      const int p = (cr.y0 + (k >> 1) * cr.dy) * R + cr.x0 + (k & 1) * cr.dx;
      h = static_cast<int>((static_cast<unsigned>(p) * 0x9E3779B1u) >> 24);
      for (;;) {
        const int prev = atomicCAS(&s_key[h], -1, p);
        if (prev == -1 || prev == p) break;
        h = (h + 1) & (kHash - 1);
      }
    }
    s_bucket[tid] = h;
  }
  __syncthreads();
  for (int e = tid; e < kHash; e += C::kT) {
    const int p = s_key[e];
    if (p < 0) continue;
    const int slot = atomicAdd(&s_nslot, 1);
    s_pix[slot] = p;
    s_key[e] = slot;
  }

  // --- the bilinear sample -> As (zeros past F and on padding), scratch s ------
  const float* pl = plane + (long long)b * RR * F;
  for (int e = tid; e < kRB * FP; e += C::kT) {
    const int r = e / FP;
    const int c = e - r * FP;
    const float v = c < F && r < rows && s_valid[r] ? bilinear_at(pl, s_corner[r], R, F, c)
                                                    : 0.0f;
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
  const int T = TB + nH * (n1 + n2);
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
    if (t < T) {
      float* slot = ring + (t % C::kStages) * C::kSlot;
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
  for (int t = 0; t < T; ++t) {
    int kind, c, v;
    decode(t, kind, c, v);
    if (t == TA) {  // d_o = (g_c + g_plane[cell] / count) * valid -> As, scratch d_o
      __syncthreads();  // every warp is done with the sample
      const float* gp = g_plane + (long long)b * RR * F;
      for (int e = tid; e < kRB * FP; e += C::kT) {
        const int r = e / FP;
        const int cc = e - r * FP;
        float x = 0.0f;
        if (cc < F && r < rows && s_valid[r]) {
          x = g_c[(rowb + r) * F + cc];
          if (s_cell[r] >= 0) x += gp[(long long)s_cell[r] * F + cc] / s_cnt[r];
        }
        As[r * C::kLdA + cc] = x;
        if (cc < F && r < rows) do_buf[(rowb + r) * F + cc] = x;
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
    const float* W = ring + (t % C::kStages) * C::kSlot;
    if (kind == 1) {
      warp_mma<C::kKS2, C::kNT, true>(acc, As + v * C::kKS2, C::kLdA, W, C::kLdW2, wm,
                                      wq * C::kWN, lane, Fl - c * FP);
      if (v == nK - 1) {  // d_c_last's column chunk c -> global
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = wm + mt * 16 + g + (i >> 1) * 8;
            if (r >= rows) continue;
            float* crow = d_clast + (rowb + r) * Fl;
#pragma unroll
            for (int nt = 0; nt < C::kNT; ++nt) {
              const int n = c * FP + wq * C::kWN + nt * 8 + 2 * q + (i & 1);
              if (n < Fl) crow[n] = acc[mt][nt][i];
            }
          }
      }
    } else if (kind == 3) {
      warp_mma<C::kKS2, C::kNT>(acc, Hs + v * C::kKS2, C::kLdH, W, C::kLdW2, wm,
                                wq * C::kWN, lane);
    } else {
      warp_mma<C::kKS1, C::kNT1>(hacc, As + v * C::kKS1, C::kLdA, W, C::kLdW1, wm,
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
                const float pre = n < H ? hacc[mt][nt][i] + b_in[n] : 0.0f;
                if (pre > 0.0f) bits |= 1u << e;
                if (r < rows && n < H) h_buf[(rowb + r) * H + n] = fmaxf(pre, 0.0f);
              } else {
                const float d = (bits >> e) & 1u ? hacc[mt][nt][i] : 0.0f;
                Hs[r * C::kLdH + col] = d;
                if (r < rows && n < H) dh_buf[(rowb + r) * H + n] = d;
              }
            }
        if (kind == 0) *word = (pos & 31) == 0 ? bits : *word | bits << (pos & 31);
      }
    }
  }
  cp_async_wait<0>();

  // --- d_s (acc), scattered through the bilinear weights -------------------------
  // d_s -> As [row][n]; the corners grouped by pixel (a counting sort over
  // the slots); then a thread per (pixel, channel) sums its corners' shares
  // and adds them to d_plane with one global atomic: no shared atomics on
  // floats, which serialize where a warp's rows share a pixel.
  __syncthreads();  // every warp is done with As
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + mt * 16 + g + (i >> 1) * 8;
        As[r * C::kLdA + wq * C::kWN + nt * 8 + 2 * q + (i & 1)] = acc[mt][nt][i];
      }
  const int nslot = s_nslot;
  int slot = -1, place = -1;  // this thread's corner (tid < 4 kRB): its slot and place
  if (tid < 4 * kRB && s_bucket[tid] >= 0) {
    slot = s_key[s_bucket[tid]];
    place = atomicAdd(&s_first[slot + 1], 1);
  }
  __syncthreads();
  if (warp == 0) {  // s_first: exclusive scan of the slots' counts (in s_first[1..])
    constexpr int kPer = 4 * kRB / 32;
    int run = 0, part[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      run += s_first[1 + lane * kPer + j];
      part[j] = run;
    }
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    const int before = incl - run;
#pragma unroll
    for (int j = 0; j < kPer; ++j) s_first[1 + lane * kPer + j] = before + part[j];
  }
  __syncthreads();
  if (slot >= 0) s_corners[s_first[slot] + place] = tid;
  __syncthreads();
  float* dp = d_plane + (long long)b * RR * F;
  for (int e = tid; e < nslot * F; e += C::kT) {
    const int sl = e / F;
    const int n = e - sl * F;
    float sum = 0.0f;
    for (int j = s_first[sl]; j < s_first[sl + 1]; ++j) {
      const int rk = s_corners[j];
      const Corner cr = s_corner[rk >> 2];
      const float wx = rk & 1 ? cr.wx : 1.0f - cr.wx;
      const float wy = rk & 2 ? cr.wy : 1.0f - cr.wy;
      sum += wx * wy * As[(rk >> 2) * C::kLdA + n];
    }
    if (sum != 0.0f) atomicAdd(dp + (long long)s_pix[sl] * F + n, sum);
  }
}

template <int FP>
cudaError_t launch_rows(const float* plane, const float* xy, const int* cells,
                        const uint8_t* mask, const int* counts, const float* g_plane,
                        const float* g_c, const float* w_in, const float* b_in,
                        const float* w_out_t, const float* w_c_t, const float* w_in_t,
                        float* d_plane, float* d_clast, float* s_buf, float* h_buf,
                        float* do_buf, float* dh_buf, int B, int N, int R, int F, int Fl,
                        int shift, cudaStream_t stream) {
  using C = RowCfg<FP>;
  cudaError_t err = cudaFuncSetAttribute(fused_level_bwd_rows<FP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const bool vec_h = F % 2 == 0 && aligned16(w_in) && aligned16(w_out_t);
  const bool vec_f = F % 4 == 0 && aligned16(w_in_t);
  const bool vec_l = Fl % 4 == 0 && aligned16(w_c_t);
  const dim3 grid((N + kRB - 1) / kRB, B);
  fused_level_bwd_rows<FP><<<grid, C::kT, C::kSmem, stream>>>(
      plane, xy, cells, mask, counts, g_plane, g_c, w_in, b_in, w_out_t, w_c_t, w_in_t,
      d_plane, d_clast, s_buf, h_buf, do_buf, dh_buf, N, R, F, Fl, shift, vec_h, vec_f,
      vec_l);
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
// F <= 512; any Fl.
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
    if (F > 512) return static_cast<int>(cudaErrorInvalidValue);
    const int fp = F <= 32 ? 32 : F <= 64 ? 64 : F <= 128 ? 128 : F <= 256 ? 256 : 512;
    cudaError_t err;
#define T2H_ROWS(FP)                                                                      \
  case FP:                                                                                \
    err = launch_rows<FP>(plane, xy, cells, mask, counts, g_plane, g_c, w_in, b_in, w_out_t, \
                          w_c_t, w_in_t, d_plane, d_clast, s_buf, h_buf, do_buf, dh_buf, B, \
                          N, R, F, Fl, shift, stream);                                     \
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
    if (err != cudaSuccess) return static_cast<int>(err);
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
