// K6: the whole ConvDecoder in one kernel: x1 = relu(conv3x3(x) + b1),
// x2 = relu(conv3x3(x1) + b2), x3 = relu(conv3x3(x2) + b3), then the 1x1 head
// over the virtual concat [x, x1, x2, x3] (+ b4), NHWC x HWIO, fp32: the
// Hopper version of _decoder_kernel in tomosar2height_tpu/ops/pallas/
// decoder_kernel.py (launched by _fused_fwd_impl), the fused_head decoder.
//
// The TPU kernel keeps a full-width 512-pixel row band and every
// intermediate in up to 100 MB of VMEM; one row of x2 alone (512 x 128 f32,
// 256 KB) exceeds a block's 227 KB here. So a block owns an 8x8 output tile
// and holds the tile's x with a 3-pixel halo, x1 with 2, x2 with 1 and x3 in
// shared memory (14^2*36 + 12^2*68 + 10^2*132 + 8^2*68 floats with the pixel
// strides of conv3x3.cuh, 138 KB at the flagship widths, plus a 16 KB weight
// stage), computing each conv on its
// halo-grown region in 32-channel passes with the block-level conv of
// conv3x3.cuh. Out-of-image pixels of x1 and x2 are set to 0 after their
// conv (SAME padding of the next conv's input, not relu(bias)). The head
// reads the four tiles at the centre: a warp per output pixel, lanes over
// the concat's channels, a shuffle sum.
//
// Bound on the H100: fp32 FMAs, 9 (32*64 + 64*128 + 128*64) + 288 MAC per
// output pixel (0.70 TFLOP per batch-8 forward at 512^2, ~10.4 ms at the
// 67 TFLOP/s fp32 peak). The halos recompute 1.39x the MACs (x1 on 144 and
// x2 on 100 pixels for 64 outputs): the price of a tile that fits.

#include "conv3x3.cuh"

namespace t2h {

constexpr int kDecTile = 8;
constexpr int kDecWs = 4096;  // floats of the weight stage: 128 channels x 32

// dst ([rows_out^2][pixel_stride(C)]) = relu(conv(src) + bias) over the
// rows_out^2 region, SAME-zeroed outside the image; src
// ([(rows_out+2)^2][pixel_stride(Cs)]) resident.
template <int TM>
__device__ __forceinline__ void dec_stage(const float* src, int Cs, float* dst, int rows_out,
                                          int C, const float* __restrict__ w,
                                          const float* __restrict__ bias, float* Ws,
                                          int y0, int x0, int H, int W) {
  const int tid = threadIdx.x;
  const int mg = tid % 32, col = 4 * (tid / 32);
  const int npix = rows_out * rows_out, src_cols = rows_out + 2;
  const int cs_src = pixel_stride(Cs), cs_dst = pixel_stride(C);
  int off[TM];
  pixel_offsets(off, mg, 32, npix, rows_out, src_cols, cs_src);
  for (int n0 = 0; n0 < C; n0 += kConvChunk) {
    float acc[TM][4];
    zero_acc(acc);
    conv_acc(acc, off, src, cs_src, src_cols, Cs, w, Cs, C, 0, n0, kConvChunk, col, Ws,
             kDecWs);
    store_relu_region(dst + n0, cs_dst, acc, bias, n0, col, kConvChunk, C, mg, 32, npix,
                      rows_out, y0, x0, H, W);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
conv_decoder_fwd(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, const float* __restrict__ w4,
                 const float* __restrict__ b4, float* __restrict__ out, int H, int W,
                 int C0, int C1, int C2, int C3, int CO) {
  extern __shared__ float4 smem4[];
  constexpr int T = kDecTile;
  constexpr int P0 = (T + 6) * (T + 6), P1 = (T + 4) * (T + 4), P2 = (T + 2) * (T + 2),
                P3 = T * T;
  const int cs0 = pixel_stride(C0), cs1 = pixel_stride(C1), cs2 = pixel_stride(C2),
            cs3 = pixel_stride(C3);
  float* Ws = reinterpret_cast<float*>(smem4);
  float* xs = Ws + kDecWs;   // [P0][cs0]
  float* x1 = xs + P0 * cs0;  // [P1][cs1]
  float* x2 = x1 + P1 * cs1;  // [P2][cs2]
  float* x3 = x2 + P2 * cs2;  // [P3][cs3]
  const int tiles_x = cdiv(W, T);
  const int oy = (blockIdx.x / tiles_x) * T, ox = (blockIdx.x % tiles_x) * T;
  const int b = blockIdx.y;
  load_region(xs, cs0, x, b, H, W, C0, oy - 3, ox - 3, T + 6, T + 6, 0, C0);
  __syncthreads();
  dec_stage<cdiv(P1, 32)>(xs, C0, x1, T + 4, C1, w1, b1, Ws, oy - 2, ox - 2, H, W);
  dec_stage<cdiv(P2, 32)>(x1, C1, x2, T + 2, C2, w2, b2, Ws, oy - 1, ox - 1, H, W);
  dec_stage<cdiv(P3, 32)>(x2, C2, x3, T, C3, w3, b3, Ws, oy, ox, H, W);
  // the 1x1 head over [x, x1, x2, x3] at the tile's pixels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ctot = C0 + C1 + C2 + C3;
  for (int e = warp; e < P3 * CO; e += kThreads / 32) {
    const int p = e / CO, o = e - p * CO;
    const int r = p / T, c = p % T;
    const int yy = oy + r, xx = ox + c;
    float s = 0.0f;
    for (int k = lane; k < ctot; k += 32) {
      float v;
      if (k < C0) v = xs[((r + 3) * (T + 6) + c + 3) * cs0 + k];
      else if (k < C0 + C1) v = x1[((r + 2) * (T + 4) + c + 2) * cs1 + k - C0];
      else if (k < C0 + C1 + C2) v = x2[((r + 1) * (T + 2) + c + 1) * cs2 + k - C0 - C1];
      else v = x3[p * cs3 + k - C0 - C1 - C2];
      s = fmaf(v, __ldg(w4 + (long long)k * CO + o), s);
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0 && yy < H && xx < W)
      out[(((long long)b * H + yy) * W + xx) * CO + o] = s + __ldg(b4 + o);
  }
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// x (B,H,W,C0) NHWC; w1 (3,3,C0,C1), w2 (3,3,C1,C2), w3 (3,3,C2,C3) HWIO;
// w4 (C0+C1+C2+C3, CO) -> out (B,H,W,CO).
int t2h_conv_decoder(const float* x, const float* w1, const float* b1, const float* w2,
                     const float* b2, const float* w3, const float* b3, const float* w4,
                     const float* b4, float* out, int B, int H, int W, int C0, int C1,
                     int C2, int C3, int CO, cudaStream_t stream) {
  if ((long long)B * H * W * CO == 0) return 0;
  constexpr int T = kDecTile;
  const size_t smem =
      sizeof(float) * ((size_t)kDecWs + (size_t)pixel_stride(C0) * (T + 6) * (T + 6) +
                       (size_t)pixel_stride(C1) * (T + 4) * (T + 4) +
                       (size_t)pixel_stride(C2) * (T + 2) * (T + 2) +
                       (size_t)pixel_stride(C3) * T * T);
  cudaError_t err = cudaFuncSetAttribute(
      conv_decoder_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(H, T) * cdiv(W, T), B);
  conv_decoder_fwd<<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, w3, b3, w4, b4,
                                                     out, H, W, C0, C1, C2, C3, CO);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
