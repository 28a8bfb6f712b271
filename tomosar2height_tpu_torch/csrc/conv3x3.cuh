// The block-level 3x3 SAME convolution shared by K6 (decoder.cu), K7
// (convpair.cu) and K8 (conv.cu): fp32 FMA, no tensor cores.
//
// A block holds an input region with its halo in shared memory, pixel-major
// with the channels innermost ([pixel][cs], cs = round4(channels) + 4: the
// 4 spare floats put neighbouring pixels' float4s in other banks), and
// computes an output region of P pixels x NC output channels of it: output
// pixel (y, x) reads the region's pixels (y + dy, x + dx), dy, dx in 0..2.
// The weights (HWIO, global) are staged into shared memory one tap x ks
// input channels x NC output channels at a time. Each of the 256 threads
// holds TM pixels x 4 channels: column group ng = tid / MG owns channels
// [4ng, 4ng + 4) and pixel group mg = tid % MG owns pixels mg, mg + MG, ...
// Per 4 input channels a thread reads one float4 of each of its pixels and
// four float4s of weights (a warp's weights are mostly one broadcast) for
// 16 TM FMAs.
#pragma once

#include "common.cuh"

namespace t2h {

constexpr int kConvChunk = 32;      // input channels per shared-memory chunk
constexpr int kChunkStride = 36;    // floats per pixel of a 32-channel region

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round4(int c) { return (c + 3) / 4 * 4; }
// floats per pixel of a region holding c channels
__host__ __device__ constexpr int pixel_stride(int c) { return round4(c) + 4; }

// The thread's offsets (floats) into a source region `src_cols` wide with
// `cs` floats per pixel, for an output region `out_cols` wide of `npix`
// pixels; pixels past npix read pixel 0 and are never stored.
template <int TM>
__device__ __forceinline__ void pixel_offsets(int (&off)[TM], int mg, int MG, int npix,
                                              int out_cols, int src_cols, int cs) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = mg + i * MG;
    off[i] = m < npix ? ((m / out_cols) * src_cols + m % out_cols) * cs : 0;
  }
}

// acc[i][j] += sum over taps and the kc channels of src of
//   src[off[i] + tap offset + c] * w[tap][ci0 + c][n0 + col + j].
// src: shared region ([pixel][cs], channels padded with zeros to a multiple
// of 4), rows src_cols wide. w: global HWIO (3, 3, Cin, Cout). nc: the
// output channels of this pass (a multiple of 4); threads with col >= nc
// only help stage. Ws: shared, ws_floats (16-byte aligned). Every thread of
// the block must call it: it synchronises, and it ends with a barrier, so
// src and Ws may be overwritten after it.
template <int TM>
__device__ __forceinline__ void conv_acc(float (&acc)[TM][4], const int (&off)[TM],
                                         const float* src, int cs, int src_cols, int kc,
                                         const float* __restrict__ w, int Cin, int Cout,
                                         int ci0, int n0, int nc, int col, float* Ws,
                                         int ws_floats) {
  const int tid = threadIdx.x;
  const int kc4 = round4(kc);
  int ks = (ws_floats / nc) & ~3;
  if (ks > kc4) ks = kc4;
  for (int s0 = 0; s0 < kc4; s0 += ks) {
    const int kk = min(ks, kc4 - s0);
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // the previous pass is done reading Ws
      const float* wt = w + ((long long)tap * Cin + ci0 + s0) * Cout + n0;
      for (int e = tid; e < kk * nc; e += kThreads) {
        const int k = e / nc, n = e - k * nc;
        Ws[e] = (s0 + k < kc && n0 + n < Cout) ? __ldg(wt + (long long)k * Cout + n) : 0.0f;
      }
      __syncthreads();
      if (col < nc) {
        const float* s = src + ((tap / 3) * src_cols + tap % 3) * cs + s0;
        for (int c = 0; c < kk; c += 4) {
          const float* wc = Ws + c * nc + col;
          const float4 w0 = *reinterpret_cast<const float4*>(wc);
          const float4 w1 = *reinterpret_cast<const float4*>(wc + nc);
          const float4 w2 = *reinterpret_cast<const float4*>(wc + 2 * nc);
          const float4 w3 = *reinterpret_cast<const float4*>(wc + 3 * nc);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(s + off[i] + c);
            float* r = acc[i];
            r[0] = fmaf(a.w, w3.x, fmaf(a.z, w2.x, fmaf(a.y, w1.x, fmaf(a.x, w0.x, r[0]))));
            r[1] = fmaf(a.w, w3.y, fmaf(a.z, w2.y, fmaf(a.y, w1.y, fmaf(a.x, w0.y, r[1]))));
            r[2] = fmaf(a.w, w3.z, fmaf(a.z, w2.z, fmaf(a.y, w1.z, fmaf(a.x, w0.z, r[2]))));
            r[3] = fmaf(a.w, w3.w, fmaf(a.z, w2.w, fmaf(a.y, w1.w, fmaf(a.x, w0.w, r[3]))));
          }
        }
      }
    }
  }
  __syncthreads();
}

// Load channels [ci0, ci0 + kc) of the rows x cols region at image pixel
// (y0, x0) of batch row b of an NHWC (B, H, W, C) tensor into dst
// ([rows * cols][cs]); pixels outside the image are 0 (SAME padding), and so
// are the channels from kc up to round4(kc).
__device__ __forceinline__ void load_region(float* dst, int cs, const float* __restrict__ x,
                                            int b, int H, int W, int C, int y0, int x0,
                                            int rows, int cols, int ci0, int kc) {
  const int kc4 = round4(kc);
  for (int e = threadIdx.x; e < rows * cols * kc4; e += kThreads) {
    const int p = e / kc4, c = e - p * kc4;
    const int y = y0 + p / cols, xx = x0 + p % cols;
    float v = 0.0f;
    if (c < kc && y >= 0 && y < H && xx >= 0 && xx < W)
      v = __ldg(x + (((long long)b * H + y) * W + xx) * C + ci0 + c);
    dst[p * cs + c] = v;
  }
}

// Store relu(acc + bias) of an output-region pass over channels [n0, n0 + nc)
// into dst ([pixel][cs], shared; channel n at dst[m * cs + n - n0]); region
// pixels outside the image (origin (y0, x0), `cols` wide) are 0: SAME padding
// of the next conv's input. Channels from C up to round4(C) are 0 too.
template <int TM>
__device__ __forceinline__ void store_relu_region(float* dst, int cs, const float (&acc)[TM][4],
                                                  const float* __restrict__ bias, int n0,
                                                  int col, int nc, int C, int mg, int MG,
                                                  int npix, int cols, int y0, int x0, int H,
                                                  int W) {
  if (col >= nc || n0 + col >= round4(C)) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = mg + i * MG;
    if (m >= npix) continue;
    const int y = y0 + m / cols, xx = x0 + m % cols;
    const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + col + j;
      v[j] = inside && n < C ? fmaxf(acc[i][j] + __ldg(bias + n), 0.0f) : 0.0f;
    }
    *reinterpret_cast<float4*>(dst + m * cs + col) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int TM>
__device__ __forceinline__ void zero_acc(float (&acc)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

}  // namespace t2h
