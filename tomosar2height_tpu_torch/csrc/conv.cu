// K8: one 3x3 SAME convolution + bias (+ReLU), NHWC x HWIO -> NHWC, fp32:
// the Hopper version of _conv_kernel in tomosar2height_tpu/ops/pallas/
// conv_kernel.py (launched by _conv_impl), which runs every Conv3x3 of the
// model under FAST_CONV.
//
// The TPU kernel takes a full-width row band plus two boundary rows per grid
// step and runs 9 tap matmuls on the MXU. Here a block owns a 2-D output tile
// (8x8 pixels x 64 channels, or 8x16 x 32 where Cout <= 32) of one image:
// it streams the input in 32-channel chunks as a (tile + 1-pixel halo)
// region into shared memory, zero outside the image (SAME padding), and runs
// the block-level conv of conv3x3.cuh over each chunk; bias and ReLU fuse
// into the store.
//
// Bound on the H100: fp32 FMAs, 9 * Cin * Cout MAC per output pixel
// (2.24 TFLOP for the 43 convs of a batch-8 fusion forward, ~33 ms at the
// 67 TFLOP/s fp32 peak); the bytes it must move are ~100x less. The inner
// loop issues TM + 4 float4 shared loads for 16 TM FMAs; tensor cores
// (TF32/bf16 wgmma) are the later step.

#include "conv3x3.cuh"

namespace t2h {

constexpr int kConvTM = 4;

__global__ void __launch_bounds__(kThreads)
conv3x3_fwd(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y, int H, int W,
            int Cin, int Cout, int OH, int OW, int NC, int relu) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [kConvChunk][NC]
  float* xs = Ws + kConvChunk * NC;             // [(OH+2)(OW+2)][kChunkStride]
  const int tiles_x = cdiv(W, OW);
  const int oy = (blockIdx.x / tiles_x) * OH, ox = (blockIdx.x % tiles_x) * OW;
  const int n0 = blockIdx.y * NC, b = blockIdx.z;
  const int MG = kThreads / (NC / 4);
  const int mg = threadIdx.x % MG, col = 4 * (threadIdx.x / MG);
  const int npix = OH * OW, rows = OH + 2, cols = OW + 2;
  int off[kConvTM];
  pixel_offsets(off, mg, MG, npix, OW, cols, kChunkStride);
  float acc[kConvTM][4];
  zero_acc(acc);
  for (int ci0 = 0; ci0 < Cin; ci0 += kConvChunk) {
    const int kc = min(kConvChunk, Cin - ci0);
    load_region(xs, kChunkStride, x, b, H, W, Cin, oy - 1, ox - 1, rows, cols, ci0, kc);
    __syncthreads();
    conv_acc(acc, off, xs, kChunkStride, cols, kc, w, Cin, Cout, ci0, n0, NC, col, Ws,
             kConvChunk * NC);
  }
#pragma unroll
  for (int i = 0; i < kConvTM; ++i) {
    const int m = mg + i * MG;
    const int yy = oy + m / OW, xx = ox + m % OW;
    if (m >= npix || yy >= H || xx >= W) continue;
    float* out = y + (((long long)b * H + yy) * W + xx) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + col + j;
      if (col + j >= NC || n >= Cout) continue;
      const float v = acc[i][j] + __ldg(bias + n);
      out[n] = relu ? fmaxf(v, 0.0f) : v;
    }
  }
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// x (B,H,W,Cin) NHWC, w (3,3,Cin,Cout) HWIO, bias (Cout) -> y (B,H,W,Cout).
int t2h_conv3x3(const float* x, const float* w, const float* bias, float* y, int B,
                int H, int W, int Cin, int Cout, int relu, cudaStream_t stream) {
  if ((long long)B * H * W * Cout == 0) return 0;
  const int NC = Cout <= 32 ? 32 : 64;
  const int OH = 8, OW = NC == 32 ? 16 : 8;
  const size_t smem =
      sizeof(float) * ((size_t)kConvChunk * NC + (size_t)kChunkStride * (OH + 2) * (OW + 2));
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(H, OH) * cdiv(W, OW), cdiv(Cout, NC), B);
  conv3x3_fwd<<<grid, kThreads, smem, stream>>>(x, w, bias, y, H, W, Cin, Cout, OH, OW,
                                                NC, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
