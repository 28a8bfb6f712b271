// K7: relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2), plus an optional 2x2
// max pool of the result, NHWC x HWIO, fp32: the Hopper version of
// _pair_kernel in tomosar2height_tpu/ops/pallas/convpair_kernel.py (launched
// by _pair_impl), which opens every ALTO and image U-Net level under
// fused_convs.
//
// The TPU kernel holds a full-width row band, its 8-row halos and both
// convs' full-channel intermediates in up to 100 MB of VMEM. A block here has
// 227 KB. Each conv runs as an implicit GEMM on the tensor cores at fp32
// accuracy (igemm_conv.cuh: 3xTF32 mma.sync, 64-128-pixel tiles that span
// image and batch rows, a 3-stage cp.async ring), in two passes:
// relu(conv1) goes through global memory (the wrapper's scratch) and conv2
// reads it back, with the pool in its epilogue; y is written too (the U-Net
// keeps it as before_pool). Conv2's gather zero-fills pixels outside the
// image, so its input's SAME padding is 0, not relu(b1).
//
// The form, per shape: a fused pair must recompute conv1 on its tile's
// halo (1.27x at a 16x16 tile ... 3x at the 2x4 tiles that 227 KB allows
// at 1024 channels) and every block reads both weight sets; two passes do
// neither, and the intermediates of the 20 pairs of a batch-8 fusion
// forward are 1.7 GB, written and read back once (~1 ms at the HBM rate;
// the deep levels' stay in L2). Timed on the card against the one-pass
// fp32-FMA kernel this replaced, at each of those 20 shapes in one call,
// two passes won at every one (PERF.md), so every shape takes two passes.
//
// Bound on the H100: the MACs, 9 (Cin C1 + C1 C2) per output pixel (1.54
// TFLOP for the 20 pairs of a batch-8 fusion forward), three TF32 products
// each: 9.3 ms at 495/3 TFLOP/s.
//
// Its bf16 instance, t2h_conv_pair_bf16, runs both convs on the TMA-fed
// wgmma pipeline of conv_bf16.cu (K8's, with the pool in conv2's epilogue).

#include "igemm_conv.cuh"

using namespace t2h;

namespace {

int conv_pair(const float* x, const float* w1, const float* b1, const float* w2,
              const float* b2, float* mid, float* y, float* pooled, int B, int H, int W,
              int Cin, int C1, int C2, cudaStream_t stream) {
  if ((long long)B * H * W * C2 == 0) return 0;
  cudaError_t err = conv3x3_bias(x, w1, b1, mid, nullptr, B, H, W, Cin, C1, true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv3x3_bias(mid, w2, b2, y, pooled, B, H, W, C1, C2, true, stream));
}

}  // namespace

extern "C" {

// x (B,H,W,Cin) NHWC; w1 (3,3,Cin,C1), w2 (3,3,C1,C2) HWIO; mid (B,H,W,C1)
// scratch -> y (B,H,W,C2) and, when pooled is not null, pooled
// (B,H/2,W/2,C2) (H, W even).
int t2h_conv_pair(const float* x, const float* w1, const float* b1, const float* w2,
                  const float* b2, float* mid, float* y, float* pooled, int B, int H, int W,
                  int Cin, int C1, int C2, cudaStream_t stream) {
  return conv_pair(x, w1, b1, w2, b2, mid, y, pooled, B, H, W, Cin, C1, C2, stream);
}

}  // extern "C"
