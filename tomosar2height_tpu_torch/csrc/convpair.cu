// K7: relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2), plus an optional 2x2
// max pool of the result, NHWC x HWIO, fp32: the Hopper version of
// _pair_kernel in tomosar2height_tpu/ops/pallas/convpair_kernel.py (launched
// by _pair_impl), which opens every ALTO and image U-Net level under
// fused_convs.
//
// The TPU kernel holds a full-width row band, its 8-row halos and both
// convs' full-channel intermediates in up to 100 MB of VMEM. A block here has
// 227 KB, so it owns a 2-D output tile of all c2 output channels, sized per
// level so that tile pixels x c2 = 8192 (16x16 at c2 = 32 ... 2x4 at 1024,
// at most 16x16), and never holds the whole intermediate: for each 32-channel
// chunk of c1 it computes that chunk of relu(conv1) on the tile plus a
// 1-pixel halo (streaming x in 32-channel chunks of the tile plus a 2-pixel
// halo), zeroes its out-of-image pixels (SAME padding of conv2's input: 0,
// not relu(b1)), and adds the chunk's share of conv2 into registers that
// persist across chunks. Weights stream through one 32 KB shared stage. The
// result goes through shared memory to coalesced NHWC stores of y and of the
// pooled tile (y is written too: the U-Net keeps it as before_pool).
//
// Bound on the H100: fp32 FMAs, 9 (Cin c1 + c1 c2) MAC per output pixel
// (1.54 TFLOP for the 20 pairs of a batch-8 fusion forward, ~23 ms at the
// 67 TFLOP/s fp32 peak). The halo recomputes conv1 on (OH+2)(OW+2) / (OH OW)
// of the pixels (1.27x at 16x16, 3x at 2x4): the price of small tiles at the
// deep levels, where a larger tile's registers or shared memory do not fit.

#include "conv3x3.cuh"

namespace t2h {

constexpr int kPairTM2 = 8;     // output pixels per thread (conv2)
constexpr int kPairWs = 8192;   // floats of the weight stage, and of y's staging

template <int TM1>
__global__ void __launch_bounds__(kThreads)
conv_pair_fwd(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ y,
              float* __restrict__ pooled, int H, int W, int Cin, int C1, int C2,
              int OH, int OW, int NC2) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [kPairWs]; y's tile at the end
  const int rin = OH + 4, cin_cols = OW + 4, pin = rin * cin_cols;
  const int rmid = OH + 2, cmid = OW + 2, pmid = rmid * cmid;
  float* xs = Ws + kPairWs;              // [pin][kChunkStride]
  float* mid = xs + kChunkStride * pin;  // [pmid][kChunkStride]
  const int tiles_x = cdiv(W, OW);
  const int oy = (blockIdx.x / tiles_x) * OH, ox = (blockIdx.x % tiles_x) * OW;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  // conv1 pass: 32 channels (8 column groups) x 32 pixel groups
  const int mg1 = tid % 32, col1 = 4 * (tid / 32);
  // conv2 pass: all NC2 channels; MG2 pixel groups of kPairTM2 pixels
  const int MG2 = kThreads / (NC2 / 4);
  const int mg2 = tid % MG2, col2 = 4 * (tid / MG2);
  const int npix = OH * OW;
  int off1[TM1], off2[kPairTM2];
  pixel_offsets(off1, mg1, 32, pmid, cmid, cin_cols, kChunkStride);
  pixel_offsets(off2, mg2, MG2, npix, OW, cmid, kChunkStride);
  float acc2[kPairTM2][4];
  zero_acc(acc2);
  for (int c0 = 0; c0 < C1; c0 += kConvChunk) {
    const int kc1 = min(kConvChunk, C1 - c0);
    float acc1[TM1][4];
    zero_acc(acc1);
    for (int ci0 = 0; ci0 < Cin; ci0 += kConvChunk) {
      const int kc = min(kConvChunk, Cin - ci0);
      load_region(xs, kChunkStride, x, b, H, W, Cin, oy - 2, ox - 2, rin, cin_cols, ci0, kc);
      __syncthreads();
      conv_acc(acc1, off1, xs, kChunkStride, cin_cols, kc, w1, Cin, C1, ci0, c0,
               kConvChunk, col1, Ws, kPairWs);
    }
    store_relu_region(mid, kChunkStride, acc1, b1, c0, col1, kConvChunk, C1, mg1, 32, pmid,
                      cmid, oy - 1, ox - 1, H, W);
    __syncthreads();
    conv_acc(acc2, off2, mid, kChunkStride, cmid, kc1, w2, C1, C2, c0, 0, NC2, col2, Ws,
             kPairWs);
  }
  // relu(acc2 + b2) -> Ws as [npix][C2]; then coalesced NHWC stores
  if (col2 < NC2) {
#pragma unroll
    for (int i = 0; i < kPairTM2; ++i) {
      const int m = mg2 + i * MG2;
      if (m >= npix) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = col2 + j;
        if (n < C2) Ws[m * C2 + n] = fmaxf(acc2[i][j] + __ldg(b2 + n), 0.0f);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < npix * C2; e += kThreads) {
    const int p = e / C2, n = e - p * C2;
    const int yy = oy + p / OW, xx = ox + p % OW;
    if (yy < H && xx < W) y[(((long long)b * H + yy) * W + xx) * C2 + n] = Ws[e];
  }
  if (pooled != nullptr) {
    const int ph = OH / 2, pw = OW / 2, H2 = H / 2, W2 = W / 2;
    for (int e = tid; e < ph * pw * C2; e += kThreads) {
      const int q = e / C2, n = e - q * C2;
      const int py = q / pw, px = q % pw;
      const int yy = oy / 2 + py, xx = ox / 2 + px;
      if (yy >= H2 || xx >= W2) continue;
      const float* t = Ws + (2 * py * OW + 2 * px) * C2 + n;
      const float v = fmaxf(fmaxf(t[0], t[C2]), fmaxf(t[OW * C2], t[(OW + 1) * C2]));
      pooled[(((long long)b * H2 + yy) * W2 + xx) * C2 + n] = v;
    }
  }
}

template <int TM1>
int launch_pair(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, float* y, float* pooled, int B, int H, int W, int Cin,
                int C1, int C2, int OH, int OW, int NC2, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kPairWs + (size_t)kChunkStride * (OH + 4) * (OW + 4) +
                       (size_t)kChunkStride * (OH + 2) * (OW + 2));
  cudaError_t err = cudaFuncSetAttribute(
      conv_pair_fwd<TM1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(H, OH) * cdiv(W, OW), B);
  conv_pair_fwd<TM1><<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, y, pooled, H, W,
                                                       Cin, C1, C2, OH, OW, NC2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// x (B,H,W,Cin) NHWC; w1 (3,3,Cin,C1), w2 (3,3,C1,C2) HWIO -> y (B,H,W,C2)
// and, when pooled is not null, pooled (B,H/2,W/2,C2) (H, W even). C2 <= 1024.
int t2h_conv_pair(const float* x, const float* w1, const float* b1, const float* w2,
                  const float* b2, float* y, float* pooled, int B, int H, int W,
                  int Cin, int C1, int C2, cudaStream_t stream) {
  if ((long long)B * H * W * C2 == 0) return 0;
  if (C2 > 1024 || (pooled != nullptr && (H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int NC2 = (C2 + 3) / 4 * 4;
  int cap = (kThreads / (NC2 / 4)) * kPairTM2;  // tile pixels the registers hold
  if (cap > 256) cap = 256;
  int OW = 2;
  while (OW * OW < cap) OW *= 2;  // OW = 2^ceil(log2(sqrt(cap)))
  const int OH = (cap / OW) & ~1;  // 16x16, 8x16, 8x8, 4x8, 4x4, 2x4; even: the pool's
                                   // 2x2 windows never straddle two tiles
  const int tm1 = cdiv((OH + 2) * (OW + 2), 32);
  if (tm1 <= 2)
    return launch_pair<2>(x, w1, b1, w2, b2, y, pooled, B, H, W, Cin, C1, C2, OH, OW, NC2, stream);
  if (tm1 <= 4)
    return launch_pair<4>(x, w1, b1, w2, b2, y, pooled, B, H, W, Cin, C1, C2, OH, OW, NC2, stream);
  if (tm1 <= 6)
    return launch_pair<6>(x, w1, b1, w2, b2, y, pooled, B, H, W, Cin, C1, C2, OH, OW, NC2, stream);
  return launch_pair<11>(x, w1, b1, w2, b2, y, pooled, B, H, W, Cin, C1, C2, OH, OW, NC2, stream);
}

}  // extern "C"
