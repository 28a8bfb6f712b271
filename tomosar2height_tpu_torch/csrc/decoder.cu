// K6: the whole ConvDecoder: x1 = relu(conv3x3(x) + b1), x2 =
// relu(conv3x3(x1) + b2), x3 = relu(conv3x3(x2) + b3), then the 1x1 head over
// the virtual concat [x, x1, x2, x3] (+ b4), NHWC x HWIO, fp32: the Hopper
// version of _decoder_kernel in tomosar2height_tpu/ops/pallas/
// decoder_kernel.py (launched by _fused_fwd_impl), the fused_head decoder.
//
// The TPU kernel keeps a full-width 512-pixel row band and every
// intermediate in up to 100 MB of VMEM; one row of x2 alone (512 x 128 f32,
// 256 KB) exceeds a block's 227 KB here. One fused pass would have to
// recompute x1 and x2 on its tile's halos (1.39x the MACs at an 8x8 tile,
// the largest whose four activations fit) and read all three weight sets in
// every block. So K6 runs three implicit-GEMM convs on the tensor cores at
// fp32 accuracy (igemm_conv.cuh: 3xTF32 mma.sync, 128-pixel tiles over the
// whole batch), three launches: conv1 writes x1 and conv2 writes x2 to the
// wrapper's scratch; conv3 (conv3x3_head_igemm, one block column covers its
// C3 <= 64 channels) stages x3 in shared memory and runs the head in its
// epilogue, reading x and x1 at the tile's pixels; x3 never leaves the
// block. The scratch is 8 x 512^2 x (64 + 128) x 4 B = 1.61 GB, written and
// read once (~1 ms at the HBM rate). Each conv's gather zero-fills pixels
// outside the image, so the SAME padding of x1 and x2 is 0 by construction,
// not relu(bias).
//
// Bound on the H100: 9 (32*64 + 64*128 + 128*64) MAC per output pixel at
// three TF32 products each (0.697 TFLOP per batch-8 forward at 512^2, 4.2
// ms at 495/3 TFLOP/s), plus the head's 288 MAC at fp32 FMA.
//
// K6 in bf16 (t2h_conv_decoder_bf16) runs on conv_bf16.cu's TMA-fed wgmma
// pipeline instead, the head in its third conv's epilogue.

#include "igemm_conv.cuh"

using namespace t2h;

namespace {

int conv_decoder(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* b2, const float* w3, const float* b3, const float* w4,
                 const float* b4, float* x1, float* x2, float* out, int B, int H, int W, int C0,
                 int C1, int C2, int C3, int CO, cudaStream_t stream) {
  if ((long long)B * H * W * CO == 0) return 0;
  if (C3 > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = conv3x3_bias(x, w1, b1, x1, nullptr, B, H, W, C0, C1, true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3_bias(x1, w2, b2, x2, nullptr, B, H, W, C1, C2, true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecoderHead<float> head = {x, x1, x2, w4, b4, out, C0, C1, C2, CO};
  return static_cast<int>(conv3x3_head(x2, w3, b3, B, H, W, C2, C3, head, stream));
}

}  // namespace

extern "C" {

// x (B,H,W,C0) NHWC; w1 (3,3,C0,C1), w2 (3,3,C1,C2), w3 (3,3,C2,C3) HWIO;
// w4 (C0+C1+C2+C3, CO); x1 (B,H,W,C1) and x2 (B,H,W,C2) scratch -> out
// (B,H,W,CO). C3 <= 64.
int t2h_conv_decoder(const float* x, const float* w1, const float* b1, const float* w2,
                     const float* b2, const float* w3, const float* b3, const float* w4,
                     const float* b4, float* x1, float* x2, float* out, int B, int H, int W,
                     int C0, int C1, int C2, int C3, int CO, cudaStream_t stream) {
  return conv_decoder(x, w1, b1, w2, b2, w3, b3, w4, b4, x1, x2, out, B, H, W, C0, C1, C2,
                      C3, CO, stream);
}

}  // extern "C"
