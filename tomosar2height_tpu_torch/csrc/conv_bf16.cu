// K8, K7 and K6 in bf16 on one pipeline: a 3x3 SAME convolution + f32 bias
// (+ReLU), NHWC x HWIO -> NHWC, bf16 x, kernel and y, with an optional 2x2
// max pool of y, or the conv decoder's 1x1 head, in its epilogue. The
// Hopper version of _conv_kernel in
// tomosar2height_tpu/ops/pallas/conv_kernel.py:43 (launched by _conv_impl)
// on bf16 operands (:57-73: the bf16 products summed in f32 onto the bias,
// the ReLU, one rounding to bf16), which runs every Conv3x3 of a bf16 model
// under FAST_CONV (t2h_conv3x3_bf16), and of _pair_kernel in
// tomosar2height_tpu/ops/pallas/convpair_kernel.py:36 with bf16 x (:99,
// 122-142), which opens every ALTO and image U-Net level under fused_convs
// (t2h_conv_pair_bf16: two launches, relu(conv1) rounded to bf16 into the
// wrapper's scratch and read back by conv2, whose SAME padding stays 0 and
// not relu(b1); the biases rounded to bf16 and added in f32; the five
// pooled pairs pool in conv2's epilogue), and of _decoder_kernel in
// tomosar2height_tpu/ops/pallas/decoder_kernel.py:85 with bf16 x (:26-30,
// 242-267), the fused_head decoder (t2h_conv_decoder_bf16: x1 =
// relu(conv1(x)), x2 = relu(conv2(x1)) through the wrapper's bf16 scratch,
// then conv3 with the head out = b4 + [x, x1, x2, x3] @ w4 in its epilogue,
// f32 out; every weight and bias rounded to bf16, x1, x2 and x3 too).
//
// Bound on the H100: the MACs, 9 Cin Cout a pixel: 2.24 TFLOP for the 43
// convs of a batch-8 fusion forward, 2.26 ms at 989 TFLOP/s (bf16 dense);
// 1.54 TFLOP, 1.56 ms, for its 20 pairs; the bytes (x and the weights read
// once, y written once) weigh less except at the 512^2 convs with 32-64
// channels. The design, an implicit GEMM (M = pixels, N = Cout, K = 9 Cin)
// on warpgroup products fed by the TMA:
//
// - Tiles: a block owns 128 output pixels, a TH x TW rectangle of one image
//   (TW = min(W, 128), TH = 128 / TW: 1 x 128 at 512^2, 8 x 16 at 16^2), by
//   BN = 64, 128 or 256 output channels (256 where Cout >= 256 still gives
//   a block an SM). Two consumer warpgroups own 64 pixels each. With the
//   pool the rectangle has an even height at an even row, so that it holds
//   whole 2x2 windows: TW = min(W, 64), TH = 128 / TW rounded down to even
//   (2 x 64 wherever W >= 128; the same as unpooled below W = 128).
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
//   image or Cout dropped). The pool reads the same staged boxes while the
//   TMA stores them: a thread a pooled pixel and 8 channels takes the max
//   of the four bf16-rounded values (the max of the rounded y, as JAX pools
//   its bf16 y; rounding is monotone) and stores 16 bytes.
// - K6's head (conv3, Cout = C3 <= 64: BN = 64, one block owns all of x3's
//   channels for its 128 pixels): the epilogue rounds relu(acc + b3) to
//   bf16 into the staged box as above and stores nothing; then two threads
//   a pixel contract x3's staged row, and x, x1 and x2 read at the pixel
//   (contiguous NHWC rows, 16-byte loads; x2 was just read through L2 by
//   the taps), with w4 (f32 in shared memory after the ring, loaded before
//   the products; 8 KB of columns a pass), the two halves added, the parts
//   summed onto b4 in the plain composition's order; f32 out. x3 never
//   leaves the block. The head is 288 of ~166k MACs a pixel at the model's
//   widths (32, 64, 128, 64), so fp32 FMA serves it; its bytes, x, x1 and x2
//   read once more (0.94 GB at batch 8 and 512^2), are the larger cost.
//   Bound: 0.697 TFLOP of bf16 products, 0.70 ms at 989 TFLOP/s; x1 and x2
//   written and read once, x read twice, ~2.6 GB, ~0.8 ms at 3.35 TB/s.
// - Numerics: each wgmma adds its 16 products into the running f32 sum; a
//   chain is 9 Cin / 16 adds (576 at Cin 1024), far below what reaches the
//   one bf16 rounding. Each output is written once: bit-equal run to run.
//
// Cin or Cout not a multiple of 8 (the image U-Net's first conv, Cin = 3: a
// 6-byte pixel pitch, which the TMA cannot take; it wants 16-byte strides)
// or x, w, y (or the pooled output) not 16-byte aligned: the conv core's
// bf16 flat-K path instead (igemm_conv.cuh conv3x3_igemm on mma.sync, with
// its own pool), chosen by shape here, conv by conv; K6's third conv with
// its head takes the core's conv3x3_head_igemm unless C0..C3 are all
// multiples of 8 and x, x1, x2, w3 16-byte aligned. The host plan (the
// route, the rectangles, each tap's box origin, BN, the pooled rectangles,
// the head's w4 columns a pass) is mirrored by ops/cuda/tile_plan.py, which
// tests/test_torch_tile_plan.py emulates.

#include "igemm_conv.cuh"
#include "wgmma_bf16.cuh"

namespace t2h {

constexpr int kPix = 128;  // output pixels a block

struct ConvPlan {
  int tw, th, tiles_x, tiles_y, rects, ck, bn;
};

inline bool conv_wgmma_route(int Cin, int Cout, const void* x, const void* w, const void* y,
                             const void* pooled) {
  return Cin % 8 == 0 && Cout % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(y) &&
         aligned16(pooled);
}

// pool: rectangles of whole 2x2 windows (even TW, TH and origins; W even)
inline ConvPlan conv_plan(int B, int H, int W, int Cin, int Cout, bool pool) {
  ConvPlan p;
  const int wmax = pool ? kPix / 2 : kPix;
  p.tw = W < wmax ? W : wmax;
  p.th = kPix / p.tw;
  if (pool) p.th &= ~1;
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

// The decoder head's columns of w4 a pass (HEAD): ``oc`` of them, as f32
// rows of oc in shared memory after the ring, so that w4s[k oc + j] is w4's
// row k, column o0 + j.
__device__ __forceinline__ void load_head_w4(float* w4s, const DecoderHead<bf16>& h, int ct,
                                             int o0, int oc, int tid, int nthreads) {
  const int on = min(oc, h.CO - o0);
  for (int i = tid; i < ct * on; i += nthreads) {
    const int k = i / on, j = i - k * on;
    w4s[k * oc + j] = __bfloat162float(h.w4[(long long)k * h.CO + o0 + j]);
  }
}

// one part of the head: the C (a multiple of 8) bf16 values at row (16-byte
// aligned) against w4s rows koff.., column j; this thread's 16-byte chunks
// are hf, hf + 2, ...
__device__ __forceinline__ float head_part(const bf16* __restrict__ row, int C, const float* w4s,
                                           int koff, int oc, int j, int hf) {
  float s = 0.0f;
#pragma unroll 4
  for (int q = hf; q < C / 8; q += 2) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + q);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float* w = w4s + (koff + 8 * q) * oc + j;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      s = fmaf(f.x, w[(2 * e) * oc], s);
      s = fmaf(f.y, w[(2 * e + 1) * oc], s);
    }
  }
  return s;
}

// K6's head in conv3's epilogue: out = b4 + [x, x1, x2, x3] @ w4 at the
// block's pixels, x3 (Cout <= 64 channels, one 64-channel box) as staged in
// the ring in bf16; x, x1 and x2 read at the pixels (contiguous NHWC rows,
// 16-byte loads). Two threads a pixel, each on every other 16-byte chunk of
// each part; their sums added, then the parts in the plain composition's
// order onto b4. w4's columns oc at a time (one pass where CO <= oc).
__device__ __forceinline__ void run_head(const uint8_t* ring, float* w4s,
                                         const DecoderHead<bf16>& h, int ct, int oc, int b,
                                         int x0, int y0, int tw, int th, int H, int W, int C3,
                                         int tid) {
  constexpr int kConsumers = 256;
  const int p = tid >> 1, hf = tid & 1;
  const int py = p / tw, px = p - py * tw;
  const int gy = y0 + py, gx = x0 + px;
  const bool in = py < th && gy < H && gx < W;
  const long long pix = ((long long)b * H + (in ? gy : 0)) * W + (in ? gx : 0);
  const int c01 = h.C0 + h.C1, c012 = c01 + h.C2;
  for (int o0 = 0; o0 < h.CO; o0 += oc) {
    if (o0 > 0) {
      named_barrier(1, kConsumers);  // every thread is done with the columns before
      load_head_w4(w4s, h, ct, o0, oc, tid, kConsumers);
      named_barrier(1, kConsumers);
    }
    const int on = min(oc, h.CO - o0);
    for (int j = 0; j < on; ++j) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (in) {
        s[0] = head_part(h.x0 + pix * h.C0, h.C0, w4s, 0, oc, j, hf);
        s[1] = head_part(h.x1 + pix * h.C1, h.C1, w4s, h.C0, oc, j, hf);
        s[2] = head_part(h.x2 + pix * h.C2, h.C2, w4s, c01, oc, j, hf);
        for (int q = hf; q < C3 / 8; q += 2) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(ring + p * 128 + ((q ^ (p % 8)) << 4));
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
          const float* w = w4s + (c012 + 8 * q) * oc + j;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            s[3] = fmaf(f.x, w[(2 * e) * oc], s[3]);
            s[3] = fmaf(f.y, w[(2 * e + 1) * oc], s[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
      if (in && hf == 0)
        h.out[pix * h.CO + o0 + j] = (((__ldg(h.b4 + o0 + j) + s[0]) + s[1]) + s[2]) + s[3];
    }
  }
}

template <int CK, int BN, bool HEAD>
__global__ void __launch_bounds__(ConvCfg<CK, BN>::kThreads, ConvCfg<CK, BN>::kMinBlocks)
conv3x3_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_y, const float* __restrict__ bias,
              bf16* __restrict__ pooled, int H, int W, int Cin, int Cout, int tw, int th,
              int tiles_x, int tiles_y, bool relu, const DecoderHead<bf16> head, int oc) {
  using C = ConvCfg<CK, BN>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* w4s = reinterpret_cast<float*>(ring + (size_t)S * C::kStage);  // HEAD: w4's columns
  const int ct = head.C0 + head.C1 + head.C2 + Cout;                     // HEAD: w4's rows

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

  if constexpr (HEAD) load_head_w4(w4s, head, ct, 0, oc, tid, C::kConsumers);
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
  if constexpr (HEAD) {
    named_barrier(1, C::kConsumers);  // x3 staged; w4's first columns loaded
    run_head(ring, w4s, head, ct, oc, b, x0, y0, tw, th, H, W, Cout, tid);
    return;
  }
  fence_async_shared();
  named_barrier(1, C::kConsumers);
  if (tid == 0) {
    for (int i = 0; i < C::kBBoxes && n0 + 64 * i < Cout; ++i)
      tma_store_4d(&map_y, ring + i * C::kOutBox, n0 + 64 * i, x0, y0, b);
    tma_store_commit();
  }
  if (pooled != nullptr) {
    // the 2x2 max pool from the staged boxes: pooled pixel (py, px) of the
    // rectangle is the max of its pixels 2py tw + 2px, + 1, + tw, + tw + 1;
    // a thread a pooled pixel and a 16-byte chunk of 8 channels (Cout % 8
    // == 0 on this route, so a chunk lies wholly inside or past Cout)
    const int pw = tw / 2, ph = th / 2, hp = H / 2, wp = W / 2;
    constexpr int kChunks = BN / 8;
    for (int e = tid; e < ph * pw * kChunks; e += C::kConsumers) {
      const int q = e / kChunks, cj = e - q * kChunks;
      const int py = q / pw, px = q - py * pw;
      const int gy = y0 / 2 + py, gx = x0 / 2 + px, n = n0 + 8 * cj;
      if (gy >= hp || gx >= wp || n >= Cout) continue;
      const uint8_t* box = ring + (cj / 8) * C::kOutBox;
      const int j = cj % 8, p = 2 * py * tw + 2 * px;
      uint4 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pc = p + (c & 1) + (c >> 1) * tw;
        v[c] = *reinterpret_cast<const uint4*>(box + pc * 128 + ((j ^ (pc % 8)) << 4));
      }
      uint4 m;
      uint32_t* mo = reinterpret_cast<uint32_t*>(&m);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 a = __hmax2(reinterpret_cast<const __nv_bfloat162*>(&v[0])[k],
                                         reinterpret_cast<const __nv_bfloat162*>(&v[1])[k]);
        const __nv_bfloat162 c = __hmax2(reinterpret_cast<const __nv_bfloat162*>(&v[2])[k],
                                         reinterpret_cast<const __nv_bfloat162*>(&v[3])[k]);
        const __nv_bfloat162 r = __hmax2(a, c);
        mo[k] = *reinterpret_cast<const uint32_t*>(&r);
      }
      *reinterpret_cast<uint4*>(pooled + (((long long)b * hp + gy) * wp + gx) * Cout + n) = m;
    }
  }
  if (tid == 0) tma_store_wait_read();
}

// HEAD: conv3 of K6 with the decoder head in its epilogue (y null: x3 is
// not written; the head's w4 columns, oc a pass, after the ring)
template <int CK, int BN, bool HEAD = false>
cudaError_t launch_conv_wgmma(const bf16* x, const bf16* w, const float* bias, bf16* y,
                              bf16* pooled, const ConvPlan& p, int B, int H, int W, int Cin,
                              int Cout, bool relu, cudaStream_t stream,
                              const DecoderHead<bf16>& head = {}, int oc = 0) {
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
  if (err == cudaSuccess && !HEAD)
    err = bf16_tensor_map<4>(&map_y, y, {cout, (uint64_t)W, (uint64_t)H, (uint64_t)B},
                             {cout * 2, cout * 2 * W, cout * 2 * W * H},
                             {64u, (uint32_t)p.tw, (uint32_t)p.th, 1u}, 128);
  if (err != cudaSuccess) return err;
  if (HEAD) map_y = map_x;  // unused
  const size_t smem =
      C::kSmem + (HEAD ? (size_t)(head.C0 + head.C1 + head.C2 + Cout) * oc * sizeof(float) : 0);
  err = cudaFuncSetAttribute(conv3x3_wgmma<CK, BN, HEAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.rects * ((Cout + BN - 1) / BN);
  conv3x3_wgmma<CK, BN, HEAD><<<static_cast<unsigned>(blocks), C::kThreads, smem, stream>>>(
      map_x, map_w, map_y, bias, pooled, H, W, Cin, Cout, p.tw, p.th, p.tiles_x, p.tiles_y,
      relu, head, oc);
  return cudaGetLastError();
}

// y = act(conv3x3(x, w) + bias), one rounding, and its 2x2 max pool into
// pooled where that is not null (after the ReLU; H, W even): Cin and Cout
// multiples of 8 with 16-byte aligned tensors on conv3x3_wgmma, any other
// on the conv core's flat-K path.
inline cudaError_t conv3x3_bf16(const bf16* x, const bf16* w, const float* bias, bf16* y,
                                bf16* pooled, int B, int H, int W, int Cin, int Cout, bool relu,
                                cudaStream_t stream) {
  if ((long long)B * H * W * Cout == 0) return cudaSuccess;
  if (pooled != nullptr && (!relu || H % 2 || W % 2)) return cudaErrorInvalidValue;
  if (!conv_wgmma_route(Cin, Cout, x, w, y, pooled))
    return conv3x3_bias(x, w, bias, y, pooled, B, H, W, Cin, Cout, relu, stream);
  const ConvPlan p = conv_plan(B, H, W, Cin, Cout, pooled != nullptr);
#define T2H_CONV(CK, BN) \
  launch_conv_wgmma<CK, BN>(x, w, bias, y, pooled, p, B, H, W, Cin, Cout, relu, stream)
  if (p.ck == 32)
    return p.bn == 64 ? T2H_CONV(32, 64) : p.bn == 128 ? T2H_CONV(32, 128) : T2H_CONV(32, 256);
  return p.bn == 64 ? T2H_CONV(64, 64) : p.bn == 128 ? T2H_CONV(64, 128) : T2H_CONV(64, 256);
#undef T2H_CONV
}

constexpr int kHeadW4Bytes = 8192;  // shared memory for w4's columns a pass

// The w4 columns a pass of K6's head (tile_plan.decoder_plan's "oc"): as
// many as fit kHeadW4Bytes of f32 rows, at least one, at most CO.
inline int head_columns(int ct, int CO) {
  const int oc = kHeadW4Bytes / (ct * (int)sizeof(float));
  return oc < 1 ? 1 : oc > CO ? CO : oc;
}

// The head's wgmma route: every width a multiple of 8 (16-byte rows for the
// TMA and the head's loads) and x3's within one 64-channel block column,
// every tensor the head or the conv reads 16-byte aligned.
inline bool head_wgmma_route(const DecoderHead<bf16>& h, const bf16* x2, const bf16* w3,
                             int C3) {
  return h.C0 % 8 == 0 && h.C1 % 8 == 0 && h.C2 % 8 == 0 && C3 % 8 == 0 && C3 <= 64 &&
         aligned16(h.x0) && aligned16(h.x1) && aligned16(x2) && aligned16(w3);
}

// K6's third conv with the head in its epilogue: x3 = relu(conv3x3(x2, w3)
// + b3) rounded to bf16 in shared memory, then h.out = b4 + [x, x1, x2, x3]
// @ w4; x3 never written. On conv3x3_wgmma (BN = 64: one block owns all of
// x3's channels for its 128 pixels) where head_wgmma_route holds, else on
// the conv core (conv3x3_head_igemm).
inline cudaError_t conv3x3_head_bf16(const bf16* x2, const bf16* w3, const float* b3, int B,
                                     int H, int W, int C2, int C3, const DecoderHead<bf16>& h,
                                     cudaStream_t stream) {
  if (C3 > 64) return cudaErrorInvalidValue;
  if ((long long)B * H * W * h.CO == 0) return cudaSuccess;
  if (!head_wgmma_route(h, x2, w3, C3))
    return conv3x3_head(x2, w3, b3, B, H, W, C2, C3, h, stream);
  const ConvPlan p = conv_plan(B, H, W, C2, C3, false);
  const int oc = head_columns(h.C0 + h.C1 + h.C2 + C3, h.CO);
  return p.ck == 32 ? launch_conv_wgmma<32, 64, true>(x2, w3, b3, nullptr, nullptr, p, B, H, W,
                                                      C2, C3, true, stream, h, oc)
                    : launch_conv_wgmma<64, 64, true>(x2, w3, b3, nullptr, nullptr, p, B, H, W,
                                                      C2, C3, true, stream, h, oc);
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// x (B,H,W,Cin) NHWC, w (3,3,Cin,Cout) HWIO, y (B,H,W,Cout) in bf16, bias
// (Cout) fp32: y = act(conv3x3(x, w) + bias), one rounding (K8).
int t2h_conv3x3_bf16(const bf16* x, const bf16* w, const float* bias, bf16* y, int B, int H,
                     int W, int Cin, int Cout, int relu, cudaStream_t stream) {
  return static_cast<int>(
      conv3x3_bf16(x, w, bias, y, nullptr, B, H, W, Cin, Cout, relu != 0, stream));
}

// K7: x (B,H,W,Cin) NHWC; w1 (3,3,Cin,C1), w2 (3,3,C1,C2) HWIO; mid
// (B,H,W,C1) scratch -> y (B,H,W,C2) and, when pooled is not null, pooled
// (B,H/2,W/2,C2) (H, W even), all bf16; b1, b2 fp32 (bf16-rounded):
// y = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2), each conv's output
// rounded to bf16 once; each conv takes its own route.
int t2h_conv_pair_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                       const float* b2, bf16* mid, bf16* y, bf16* pooled, int B, int H, int W,
                       int Cin, int C1, int C2, cudaStream_t stream) {
  if ((long long)B * H * W * C2 == 0) return 0;
  if (pooled != nullptr && (H % 2 || W % 2)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = conv3x3_bf16(x, w1, b1, mid, nullptr, B, H, W, Cin, C1, true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv3x3_bf16(mid, w2, b2, y, pooled, B, H, W, C1, C2, true, stream));
}

// K6 in bf16: x (B,H,W,C0) NHWC; w1 (3,3,C0,C1), w2 (3,3,C1,C2), w3
// (3,3,C2,C3) HWIO; w4 (C0+C1+C2+C3, CO); x1 (B,H,W,C1) and x2 (B,H,W,C2)
// scratch, all bf16; biases and b4 fp32 (bf16-rounded) -> out (B,H,W,CO)
// fp32. x1 and x2 each rounded to bf16 once, x3 too, in shared memory; C3
// <= 64. Each conv takes its own route (conv1 and conv2 conv3x3_bf16's,
// conv3 and the head conv3x3_head_bf16's).
int t2h_conv_decoder_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                          const float* b2, const bf16* w3, const float* b3, const bf16* w4,
                          const float* b4, bf16* x1, bf16* x2, float* out, int B, int H,
                          int W, int C0, int C1, int C2, int C3, int CO, cudaStream_t stream) {
  if ((long long)B * H * W * CO == 0) return 0;
  if (C3 > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = conv3x3_bf16(x, w1, b1, x1, nullptr, B, H, W, C0, C1, true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3_bf16(x1, w2, b2, x2, nullptr, B, H, W, C1, C2, true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecoderHead<bf16> head = {x, x1, x2, w4, b4, out, C0, C1, C2, CO};
  return static_cast<int>(conv3x3_head_bf16(x2, w3, b3, B, H, W, C2, C3, head, stream));
}

}  // extern "C"
