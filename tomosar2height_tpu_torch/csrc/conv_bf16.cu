// K8 in bf16: one 3x3 SAME convolution + f32 bias (+ReLU), NHWC x HWIO ->
// NHWC, bf16 x, kernel and y: the Hopper version of _conv_kernel in
// tomosar2height_tpu/ops/pallas/conv_kernel.py:43 (launched by _conv_impl)
// on bf16 operands (:57-73: the bf16 products summed in f32 onto the bias,
// the ReLU, one rounding to bf16), which runs every Conv3x3 of a bf16 model
// under FAST_CONV.
//
// Bound on the H100: the MACs, 9 Cin Cout a pixel: 2.24 TFLOP for the 43
// convs of a batch-8 fusion forward, 2.26 ms at 989 TFLOP/s (bf16 dense);
// the bytes (x and the weights read once, y written once) weigh less except
// at the 512^2 convs with 32-64 channels. The design, an implicit GEMM
// (M = pixels, N = Cout, K = 9 Cin) on warpgroup products fed by the TMA:
//
// - Tiles: a block owns 128 output pixels, a TH x TW rectangle of one image
//   (TW = min(W, 128), TH = 128 / TW: 1 x 128 at 512^2, 8 x 16 at 16^2), by
//   BN = 64, 128 or 256 output channels (256 where Cout >= 256 still gives
//   a block an SM). Two consumer warpgroups own 64 pixels each.
// - A operand: per K step (tap, CK-channel chunk), one TMA load of the 4-D
//   box (CK, TW, TH, 1) of the NHWC input at (c0, x0 + dx - 1, y0 + dy - 1,
//   b): the TMA zero-fills what lies outside the image (the SAME padding)
//   and past Cin, with no address arithmetic in any thread. The tile is
//   K-major: 128 pixel rows of CK channels (CK = 64, 128-byte swizzle; Cin
//   <= 32 takes CK = 32 and a 64-byte swizzle).
// - B operand: the HWIO rows [tap Cin + c0, + CK) x [n0, n0 + BN) by TMA, 64
//   columns a box (a 3-D map (Cout, Cin, 9), zero past Cin and Cout),
//   N-major: the wgmma's B transpose bit.
// - Pipeline: one producer warp keeps a ring of 3-6 stages full (full and
//   empty mbarriers); the consumers run wgmma m64nBNk16 bf16 -> f32, CK / 16
//   steps a stage, a stage's products in flight while they release the
//   stage before. Two blocks an SM where BN <= 128.
// - Epilogue: bias + ReLU in f32 in registers and one rounding to bf16,
//   into the ring as 64-channel boxes in the 128-byte swizzle (conflict-free
//   stores), then TMA stores of the (64, TW, TH, 1) boxes (writes past the
//   image or Cout dropped).
// - Numerics: each wgmma adds its 16 products into the running f32 sum; a
//   chain is 9 Cin / 16 adds (576 at Cin 1024), far below what reaches the
//   one bf16 rounding. Each output is written once: bit-equal run to run.
//
// Cin or Cout not a multiple of 8 (the image U-Net's first conv, Cin = 3: a
// 6-byte pixel pitch, which the TMA cannot take; it wants 16-byte strides)
// or x, w, y not 16-byte aligned: the conv core's bf16 flat-K path instead
// (igemm_conv.cuh conv3x3_igemm on mma.sync), chosen by shape here. The
// host plan (the route, the rectangles, each tap's box origin, BN) is
// mirrored by ops/cuda/tile_plan.py, which tests/test_torch_tile_plan.py
// emulates.

#include "igemm_conv.cuh"
#include "wgmma_bf16.cuh"

namespace t2h {

constexpr int kPix = 128;  // output pixels a block

struct ConvPlan {
  int tw, th, tiles_x, tiles_y, rects, ck, bn;
};

inline bool conv_wgmma_route(int Cin, int Cout, const void* x, const void* w, const void* y) {
  return Cin % 8 == 0 && Cout % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(y);
}

inline ConvPlan conv_plan(int B, int H, int W, int Cin, int Cout) {
  ConvPlan p;
  p.tw = W < kPix ? W : kPix;
  p.th = kPix / p.tw;
  p.tiles_x = (W + p.tw - 1) / p.tw;
  p.tiles_y = (H + p.th - 1) / p.th;
  p.rects = B * p.tiles_y * p.tiles_x;
  p.ck = Cin <= 32 ? 32 : 64;
  const long long blocks256 = (long long)p.rects * ((Cout + 255) / 256);
  p.bn = Cout <= 64 ? 64 : (Cout <= 128 || blocks256 < sm_count()) ? 128 : 256;
  return p;
}

template <int CK, int BN>
struct ConvCfg {
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kRowBytes = CK * 2;          // a pixel's chunk in the A tile
  static constexpr int kABytes = kPix * kRowBytes;
  static constexpr int kBBox = CK * 128;            // one 64-column box of B
  static constexpr int kBBoxes = BN / 64;
  static constexpr int kStage = kABytes + kBBoxes * kBBox;
  static constexpr int kRing = (BN == 256 ? 200 : 100) * 1024;
  static constexpr int kStages = kRing / kStage < 6 ? kRing / kStage : 6;
  static constexpr int kOutBox = kPix * 128;  // the epilogue's 64-channel box
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage;
  static_assert(kStages >= 3 && kBBoxes * kOutBox <= kStages * kStage, "ring");
};

template <int CK, int BN>
__global__ void __launch_bounds__(ConvCfg<CK, BN>::kThreads, ConvCfg<CK, BN>::kMinBlocks)
conv3x3_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_y, const float* __restrict__ bias, int Cin,
              int Cout, int tw, int th, int tiles_x, int tiles_y, bool relu) {
  using C = ConvCfg<CK, BN>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  // block -> (image b, rectangle (tx, ty), channel tile): a rectangle's
  // channel tiles are neighbours, so its input boxes are shared through L2
  const int ntn = (Cout + BN - 1) / BN;
  const int rect = blockIdx.x / ntn;
  const int n0 = (blockIdx.x - rect * ntn) * BN;
  const int tx = rect % tiles_x;
  const int ty = (rect / tiles_x) % tiles_y;
  const int b = rect / (tiles_x * tiles_y);
  const int x0 = tx * tw, y0 = ty * th;
  const int nck = (Cin + CK - 1) / CK;
  const int steps = 9 * nck;  // tap-major, then channel chunk
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {  // the producer warp: one thread issues the loads
    if (tid == C::kConsumers) {
      const uint32_t bytes = tw * th * C::kRowBytes + C::kBBoxes * C::kBBox;
      for (int it = 0; it < steps; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        uint8_t* st = ring + (size_t)s * C::kStage;
        const int tap = it / nck, c0 = (it - tap * nck) * CK;
        tma_load_4d(st, &map_x, &full[s], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
#pragma unroll
        for (int i = 0; i < C::kBBoxes; ++i)
          tma_load_3d(st + C::kABytes + i * C::kBBox, &map_w, &full[s], n0 + 64 * i, c0, tap);
      }
    }
    return;
  }

  const int wg = tid / 128;  // pixels 64 wg .. + 64 of the rectangle
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int it = 0; it < steps; ++it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const uint8_t* st = ring + (size_t)s * C::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      // A K-major: 32 bytes a k16 step inside the swizzled row; B N-major: 16 rows
      const uint64_t da = gmma_desc(st + wg * 64 * C::kRowBytes + kk * 32, 16,
                                    8 * C::kRowBytes, CK == 64 ? 1 : 2);
      const uint64_t db = gmma_desc(st + C::kABytes + kk * 2048, C::kBBox, 1024, 1);
      wgmma_bf16<BN, 0, 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one is read: release it
    if (it > 0) mbar_arrive(&empty[(it - 1) % S]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  named_barrier(1, C::kConsumers);  // every product has read the ring

  // epilogue: relu(acc + bias) rounded once, into 64-channel boxes of 128
  // pixel rows in the 128-byte swizzle, then TMA stores
  const int w = (tid % 128) / 32, lane = tid % 32;
  const int p0 = 64 * wg + 16 * w + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    const float b0 = n < Cout ? __ldg(bias + n) : 0.0f;
    const float b1 = n + 1 < Cout ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 8 * h;
      float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (relu) v0 = fmaxf(v0, 0.0f), v1 = fmaxf(v1, 0.0f);
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(ring + (j / 8) * C::kOutBox + p * 128 +
                                         (((j % 8) ^ (p % 8)) << 4) + 4 * (lane % 4)) = v;
    }
  }
  fence_async_shared();
  named_barrier(1, C::kConsumers);
  if (tid == 0) {
    for (int i = 0; i < C::kBBoxes && n0 + 64 * i < Cout; ++i)
      tma_store_4d(&map_y, ring + i * C::kOutBox, n0 + 64 * i, x0, y0, b);
    tma_store_drain();
  }
}

template <int CK, int BN>
cudaError_t launch_conv_wgmma(const bf16* x, const bf16* w, const float* bias, bf16* y,
                              const ConvPlan& p, int B, int H, int W, int Cin, int Cout,
                              bool relu, cudaStream_t stream) {
  using C = ConvCfg<CK, BN>;
  CUtensorMap map_x, map_w, map_y;
  const uint64_t cin = Cin, cout = Cout;
  cudaError_t err = bf16_tensor_map<4>(
      &map_x, x, {cin, (uint64_t)W, (uint64_t)H, (uint64_t)B},
      {cin * 2, cin * 2 * W, cin * 2 * W * H},
      {(uint32_t)CK, (uint32_t)p.tw, (uint32_t)p.th, 1u}, CK * 2);
  if (err == cudaSuccess)
    err = bf16_tensor_map<3>(&map_w, w, {cout, cin, 9}, {cout * 2, cout * 2 * cin},
                             {64u, (uint32_t)CK, 1u}, 128);
  if (err == cudaSuccess)
    err = bf16_tensor_map<4>(&map_y, y, {cout, (uint64_t)W, (uint64_t)H, (uint64_t)B},
                             {cout * 2, cout * 2 * W, cout * 2 * W * H},
                             {64u, (uint32_t)p.tw, (uint32_t)p.th, 1u}, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_wgmma<CK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.rects * ((Cout + BN - 1) / BN);
  conv3x3_wgmma<CK, BN><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      map_x, map_w, map_y, bias, Cin, Cout, p.tw, p.th, p.tiles_x, p.tiles_y, relu);
  return cudaGetLastError();
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// x (B,H,W,Cin) NHWC, w (3,3,Cin,Cout) HWIO, y (B,H,W,Cout) in bf16, bias
// (Cout) fp32: y = act(conv3x3(x, w) + bias), one rounding. Cin and Cout
// multiples of 8 with 16-byte aligned tensors take conv3x3_wgmma, any other
// the conv core's flat-K path.
int t2h_conv3x3_bf16(const bf16* x, const bf16* w, const float* bias, bf16* y, int B, int H,
                     int W, int Cin, int Cout, int relu, cudaStream_t stream) {
  if ((long long)B * H * W * Cout == 0) return 0;
  if (!conv_wgmma_route(Cin, Cout, x, w, y))
    return static_cast<int>(
        conv3x3_bias(x, w, bias, y, nullptr, B, H, W, Cin, Cout, relu != 0, stream));
  const ConvPlan p = conv_plan(B, H, W, Cin, Cout);
  cudaError_t err;
#define T2H_CONV(CK, BN) \
  launch_conv_wgmma<CK, BN>(x, w, bias, y, p, B, H, W, Cin, Cout, relu != 0, stream)
  if (p.ck == 32) {
    err = p.bn == 64 ? T2H_CONV(32, 64) : p.bn == 128 ? T2H_CONV(32, 128) : T2H_CONV(32, 256);
  } else {
    err = p.bn == 64 ? T2H_CONV(64, 64) : p.bn == 128 ? T2H_CONV(64, 128) : T2H_CONV(64, 256);
  }
#undef T2H_CONV
  return static_cast<int>(err);
}

}  // extern "C"
