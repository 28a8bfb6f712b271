// K8: one 3x3 SAME convolution + bias (+ReLU), NHWC x HWIO -> NHWC, fp32:
// the Hopper version of _conv_kernel in tomosar2height_tpu/ops/pallas/
// conv_kernel.py (launched by _conv_impl), which runs every Conv3x3 of the
// model under FAST_CONV.
//
// The TPU kernel takes a full-width row band plus two boundary rows per grid
// step and runs 9 tap matmuls on the MXU. Here the conv is one implicit GEMM
// on the tensor cores at fp32 accuracy (igemm_conv.cuh: 3xTF32 mma.sync,
// 64-128-pixel tiles that span image and batch rows, so a weight step serves
// a whole tile even at 16^2, a 3-stage cp.async ring, flat-K steps where Cin
// is not a multiple of 4), the core K7 runs twice. The gather zero-fills
// pixels outside the image (SAME padding); bias and the optional ReLU fuse
// into the staged epilogue. An input whose address is not 16-byte aligned,
// or whose Cin is not a multiple of 4, takes 4-byte copies.
//
// Bound on the H100: the MACs, 9 Cin Cout per output pixel (2.24 TFLOP for
// the 43 convs of a batch-8 fusion forward), three TF32 products each: 13.6
// ms at 495/3 TFLOP/s; the bytes it must move are ~100x less.
//
// Its bf16 instance, t2h_conv3x3_bf16, is conv_bf16.cu's (TMA and wgmma).

#include "igemm_conv.cuh"

using namespace t2h;

extern "C" {

// x (B,H,W,Cin) NHWC, w (3,3,Cin,Cout) HWIO, bias (Cout) -> y (B,H,W,Cout).
int t2h_conv3x3(const float* x, const float* w, const float* bias, float* y, int B,
                int H, int W, int Cin, int Cout, int relu, cudaStream_t stream) {
  if ((long long)B * H * W * Cout == 0) return 0;
  return static_cast<int>(
      conv3x3_bias(x, w, bias, y, nullptr, B, H, W, Cin, Cout, relu != 0, stream));
}

}  // extern "C"
