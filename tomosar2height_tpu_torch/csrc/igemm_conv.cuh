// A 3x3 SAME convolution + bias (+ReLU), NHWC x HWIO -> NHWC, as an implicit
// GEMM on the tensor cores at fp32 accuracy (3xTF32 mma.sync, mma_tf32x3.cuh),
// with an optional 2x2 max pool (after a ReLU) or the conv decoder's 1x1 head
// in its epilogue. The conv core of the port: K6 (decoder.cu), K7
// (convpair.cu) and K8 (conv.cu) run their 3x3 convs on it; K7 and K8 in
// bf16 run on conv_bf16.cu's wgmma kernel instead, but for Cin or Cout not
// a multiple of 8 (the image U-Net's Cin = 3 conv), which stays here.
//
// The GEMM: M = output pixels (B*H*W), N = output channels, K = 9 * Cin,
// walked tap by tap in kCBK-channel steps (tap-major, then channel: HWIO's
// row order, so a weight step is kCBK consecutive rows of the (9 Cin, Cout)
// matrix). A block owns a BM-pixel x BN-channel output tile. Its M rows are
// consecutive in a pixel order over the whole batch, so a tile spans image
// rows and, at the deep levels (16^2 at batch 8 is 2048 pixels), batch rows:
// each weight step serves BM pixels. With a pool the order is by 2x2 window
// (pixel m is corner m % 4 of window m / 4, windows row-major over the
// batch), so every tile holds whole windows and pooled row j is window j.
//
// Per K step, through a kCStages-deep cp.async ring: the A tile is a
// gather, row m the kCBK channels of input pixel (y + dy, x + dx), zero
// outside the image (SAME padding) and past Cin, in 16-byte copies; the B
// tile is a plain copy of the weight rows. Where Cin is not a multiple of 4
// (3 at the image U-Net's first conv) the K steps run over the flat K =
// 9 Cin instead (column k of a step: tap k / Cin, channel k % Cin), in
// 4-byte copies, so K pads to a multiple of kCBK once and not per tap.
// Warps own 32 x 32 output tiles (warp_mma: two k8 steps chain in the
// tensor cores per rounded add, K4's rule). The epilogue stages
// acc + bias (through a ReLU where asked) in shared memory, then writes y
// (NHWC rows, 16-byte stores) and, with a pool, the max of each window's four
// rows; or, in conv3x3_head_igemm, contracts each staged row with the
// decoder head's weights instead of writing it (DecoderHead).
//
// Bound on the H100: the MACs, 9 Cin Cout per output pixel, three TF32
// products each (495/3 TFLOP/s). The A gather re-reads each input pixel
// 9 times (once a tap) from L2 and each N tile re-reads the A tiles; the
// weights are read once per M tile.
//
// The element type T of x, w, y (and K6's x0..x2, w4) is float or bf16.
// bf16 (the model's bf16 dtype) keeps the same tiles, ring and epilogue: A
// and B go to shared memory as bf16 through the same cp.async ring (16-byte
// copies of 8 channels), warp_mma_bf16 (mma_bf16.cuh: ldmatrix, one
// m16n8k16 bf16 pass into fp32 accumulators) takes the place of 3xTF32,
// the bias (fp32) and the ReLU apply in fp32 and each value is rounded to
// bf16 once, where it is written (the pool's max of the rounded values is
// the rounded max: rounding is monotone). Where Cin is not a multiple of 8
// (3 at the image U-Net's first conv) the flat-K steps load through
// registers, 2 bytes at a time. The bound is then the MACs at the bf16 rate
// (989 TFLOP/s), or the bytes where they weigh more.

#pragma once

#include "dtype.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace t2h {

constexpr int kCBK = 32;     // input channels per K step
constexpr int kCStages = 3;  // K steps in flight

template <typename T, int BM, int BN>
struct ConvTile {
  static constexpr bool kBf16 = kIsBf16<T>;
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kT = 32 * (BM / 32) * kWarpsN;  // threads
  // blocks an SM that ptxas must leave room for: 512 threads' worth, so at
  // most 128 registers a thread and two 256-thread blocks an SM
  static constexpr int kMinBlocks = 512 / kT;
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy moves
  // A [BM][kLdA] and B [kCBK][kLdB], row-major in T. fp32: strides of 4 and
  // 8 (mod 32) words, for mma_tf32x3.cuh's fragment loads; bf16: rows of 80
  // and 2 (BN + 8) bytes, so that the eight 16-byte rows an ldmatrix phase
  // reads fall in eight different bank groups
  static constexpr int kLdA = kBf16 ? kCBK + 8 : kCBK + 4;
  static constexpr int kLdB = BN + 8;
  static constexpr int kLdC = BN + 4;  // the epilogue's fp32 staging [BM][kLdC]
  static constexpr int kStage = BM * kLdA + kCBK * kLdB;  // elements of T
  static constexpr int kChunks = BM * (kCBK / kVec) / kT;  // A copies a thread issues a step
  static constexpr size_t kRing = sizeof(T) * kCStages * kStage;
  static constexpr size_t kSmem =
      kRing > sizeof(float) * BM * kLdC ? kRing : sizeof(float) * BM * kLdC;
  static_assert(kT % (kCBK / kVec) == 0 && (BM * (kCBK / kVec)) % kT == 0, "A copy layout");
};

struct ConvGeom {
  int B, H, W, Cin, Cout, M;
  bool quad;  // pixel order by 2x2 window (a pool in the epilogue)
  bool relu;  // relu(acc + bias); the pool takes it
};

// The conv decoder's dense-skip 1x1 head, run in its third conv's epilogue:
// out (M, CO) = b4 + x0 w4[0:C0] + x1 w4[C0:C0+C1] + x2 w4[..C0+C1+C2] +
// x3 w4[C0+C1+C2:], x3 the conv's staged tile (C3 = its Cout); x0..x2 (M,
// C0..C2) and w4 (C0+C1+C2+C3, CO) row-major in global memory, in T; b4
// and out fp32.
template <typename T>
struct DecoderHead {
  const T* x0;
  const T* x1;
  const T* x2;
  const T* w4;
  const float* b4;
  float* out;
  int C0, C1, C2, CO;
};

__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) { return __bfloat162float(__ldg(p)); }

// Four consecutive staged fp32 values (16-byte aligned) -> dst in T.
__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store4(bf16* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Output pixel m -> (image b, row y, column x).
__device__ __forceinline__ void conv_pixel(const ConvGeom& g, int m, int& b, int& y, int& x) {
  if (g.quad) {
    const int h2 = g.H >> 1, w2 = g.W >> 1;
    const int j = m >> 2;
    b = j / (h2 * w2);
    const int r = j - b * h2 * w2;
    const int wy = r / w2;
    y = 2 * wy + ((m >> 1) & 1);
    x = 2 * (r - wy * w2) + (m & 1);
  } else {
    b = m / (g.H * g.W);
    const int r = m - b * g.H * g.W;
    y = r / g.W;
    x = r - y * g.W;
  }
}

// The block's output tile: act(conv(x, w) + bias) for its BM pixels x BN
// channels, staged in fp32 in smem ([BM][kLdC], 0 past Cout) for the
// epilogue; every thread returns after the barrier that completes it.
template <typename E, int BM, int BN>
__device__ __forceinline__ void igemm_tile(const E* __restrict__ x, const E* __restrict__ w,
                                           const float* __restrict__ bias, const ConvGeom& g,
                                           bool vec_a, bool vec_b, void* smem) {
  using T = ConvTile<E, BM, BN>;
  E* sm = static_cast<E*>(smem);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / T::kWarpsN) * 32;
  const int wn = (warp % T::kWarpsN) * 32;
  const int nc = (g.Cin + kCBK - 1) / kCBK;
  const int kflat = 9 * g.Cin;
  const int steps = vec_a ? 9 * nc : (kflat + kCBK - 1) / kCBK;

  // the tile's output pixels: image row of (b, y, x) and (y, x); y = -4
  // marks a row past M
  __shared__ int s_pix[BM], s_y[BM], s_x[BM];
  for (int r = tid; r < BM; r += T::kT) {
    int b = 0, yy = -4, xx = 0;
    if (m0 + r < g.M) conv_pixel(g, m0 + r, b, yy, xx);
    s_pix[r] = (b * g.H + yy) * g.W + xx;
    s_y[r] = yy;
    s_x[r] = xx;
  }
  __syncthreads();

  // one gathered A element (or 16-byte chunk): row r, tap offset (dy, dx),
  // channel ch of the input pixel; zero outside the image or past Cin
  auto a_src = [&](int r, int dy, int dx, int ch, bool& ok) {
    const int sy = s_y[r] + dy, sx = s_x[r] + dx;
    ok = sy >= 0 && sy < g.H && sx >= 0 && sx < g.W && ch < g.Cin;
    return x + (long long)(s_pix[r] + dy * g.W + dx) * g.Cin + ch;
  };
  auto issue = [&](int s) {
    if (s < steps) {
      E* As = sm + (s % kCStages) * T::kStage;
      E* Bs = As + BM * T::kLdA;
      if (vec_a) {  // step s: tap s / nc, channels (s % nc) * kCBK ..
        const int tap = s / nc;
        const int c0 = (s - tap * nc) * kCBK;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        constexpr int kPerRow = kCBK / T::kVec;  // 16-byte chunks of a row
        const int cv = T::kVec * (tid % kPerRow);
#pragma unroll
        for (int i = 0; i < T::kChunks; ++i) {
          const int r = tid / kPerRow + i * (T::kT / kPerRow);
          bool ok;
          const E* src = a_src(r, dy, dx, c0 + cv, ok);
          cp_async16(As + r * T::kLdA + cv, ok ? src : x, ok ? 16 : 0);
        }
        cp_tile<kCBK, BN, T::kT>(Bs, T::kLdB, w, g.Cout, (long long)tap * g.Cin + c0,
                                 (long long)tap * g.Cin + g.Cin, n0, g.Cout, vec_b, tid);
      } else {  // step s: flat k = s * kCBK .. (tap k / Cin, channel k % Cin)
        for (int e = tid; e < BM * kCBK; e += T::kT) {
          const int r = e / kCBK, c = e - r * kCBK;
          const int k = s * kCBK + c;
          const int tap = k / g.Cin;
          bool ok;
          const E* src = a_src(r, tap / 3 - 1, tap % 3 - 1, k - tap * g.Cin, ok);
          ok = ok && k < kflat;
          if constexpr (T::kBf16) {
            As[r * T::kLdA + c] = ok ? *src : __float2bfloat16_rn(0.0f);
          } else {
            cp_async4(As + r * T::kLdA + c, ok ? src : x, ok ? 4 : 0);
          }
        }
        cp_tile<kCBK, BN, T::kT>(Bs, T::kLdB, w, g.Cout, (long long)s * kCBK, kflat, n0,
                                 g.Cout, vec_b, tid);
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kCStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kCStages - 2>();
    __syncthreads();  // step s landed for every thread; step s - 1's slot is free
    issue(s + kCStages - 1);
    const E* As = sm + (s % kCStages) * T::kStage;
    if constexpr (T::kBf16) {
      warp_mma_bf16<kCBK, 4>(acc, As, T::kLdA, As + BM * T::kLdA, T::kLdB, wm, wn, lane);
    } else {
      warp_mma<kCBK, 4>(acc, As, T::kLdA, As + BM * T::kLdA, T::kLdB, wm, wn, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* Cs = static_cast<float*>(smem);  // the ring is free: stage the tile
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + mt * 16 + gq + (i >> 1) * 8;
        const int c = wn + nt * 8 + 2 * q + (i & 1);
        const int n = n0 + c;
        const float v = n < g.Cout ? acc[mt][nt][i] + __ldg(bias + n) : 0.0f;
        Cs[r * T::kLdC + c] = g.relu ? fmaxf(v, 0.0f) : v;
      }
  __syncthreads();
}

template <typename E, int BM, int BN>
__global__ void __launch_bounds__(ConvTile<E, BM, BN>::kT, ConvTile<E, BM, BN>::kMinBlocks)
conv3x3_igemm(const E* __restrict__ x, const E* __restrict__ w,
              const float* __restrict__ bias, E* __restrict__ y, E* __restrict__ pooled,
              ConvGeom g, bool vec_a, bool vec_b) {
  using T = ConvTile<E, BM, BN>;
  extern __shared__ float4 smem4[];
  const float* Cs = reinterpret_cast<const float*>(smem4);
  igemm_tile<E, BM, BN>(x, w, bias, g, vec_a, vec_b, smem4);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const bool vec_y = g.Cout % 4 == 0;
  for (int e = tid; e < BM * (BN / 4); e += T::kT) {
    const int r = e / (BN / 4), c = (e - r * (BN / 4)) * 4;
    const int m = m0 + r;
    if (m >= g.M || n0 + c >= g.Cout) continue;
    int b, yy, xx;
    conv_pixel(g, m, b, yy, xx);
    E* dst = y + ((long long)(b * g.H + yy) * g.W + xx) * g.Cout + n0 + c;
    const float* src = Cs + r * T::kLdC + c;
    if (vec_y) {
      store4(dst, src);
    } else {
      for (int j = 0; j < 4 && n0 + c + j < g.Cout; ++j) dst[j] = from_f32<E>(src[j]);
    }
  }
  if (pooled != nullptr) {
    for (int e = tid; e < (BM / 4) * BN; e += T::kT) {
      const int j = e / BN, c = e - j * BN;
      const int m = m0 + 4 * j;
      if (m >= g.M || n0 + c >= g.Cout) continue;
      const float* t = Cs + 4 * j * T::kLdC + c;
      const float v = fmaxf(fmaxf(t[0], t[T::kLdC]), fmaxf(t[2 * T::kLdC], t[3 * T::kLdC]));
      pooled[(long long)(m >> 2) * g.Cout + n0 + c] = from_f32<E>(v);
    }
  }
}

// K6's third conv with the decoder head in its epilogue: one block covers
// every output channel (BN >= C3, one block column), and x3 never leaves
// shared memory. A warp takes one staged row (pixel) at a time, lanes over
// the channels of each part, four sums reduced by shuffles and added in the
// plain composition's part order. The head is 288 of ~166k MACs a pixel at
// the flagship widths, so fp32 FMA serves it; x0..x2 are read at the tile's
// pixels (x2 was just gathered, mostly from L2). In bf16 the staged x3 is
// rounded to bf16 first (the JAX kernel keeps x3 in the model dtype), and
// the products of bf16 values are exact in fp32.
template <typename E, int BM, int BN>
__global__ void __launch_bounds__(ConvTile<E, BM, BN>::kT, ConvTile<E, BM, BN>::kMinBlocks)
conv3x3_head_igemm(const E* __restrict__ x, const E* __restrict__ w,
                   const float* __restrict__ bias, ConvGeom g, bool vec_a, bool vec_b,
                   DecoderHead<E> h) {
  using T = ConvTile<E, BM, BN>;
  extern __shared__ float4 smem4[];
  const float* Cs = reinterpret_cast<const float*>(smem4);
  igemm_tile<E, BM, BN>(x, w, bias, g, vec_a, vec_b, smem4);
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM;
  const int c01 = h.C0 + h.C1, c012 = c01 + h.C2;
  for (int r = threadIdx.x >> 5; r < BM && m0 + r < g.M; r += T::kT / 32) {
    const long long m = m0 + r;
    const E* p0 = h.x0 + m * h.C0;
    const E* p1 = h.x1 + m * h.C1;
    const E* p2 = h.x2 + m * h.C2;
    const float* p3 = Cs + r * T::kLdC;
    for (int o = 0; o < h.CO; ++o) {
      const E* w4 = h.w4 + o;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = lane; k < h.C0; k += 32)
        s[0] = fmaf(ldg_f32(p0 + k), ldg_f32(w4 + k * h.CO), s[0]);
      for (int k = lane; k < h.C1; k += 32)
        s[1] = fmaf(ldg_f32(p1 + k), ldg_f32(w4 + (h.C0 + k) * h.CO), s[1]);
      for (int k = lane; k < h.C2; k += 32)
        s[2] = fmaf(ldg_f32(p2 + k), ldg_f32(w4 + (c01 + k) * h.CO), s[2]);
      for (int k = lane; k < g.Cout; k += 32)
        s[3] = fmaf(to_f32(from_f32<E>(p3[k])), ldg_f32(w4 + (c012 + k) * h.CO), s[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 16; d > 0; d /= 2) s[i] += __shfl_xor_sync(0xffffffffu, s[i], d);
      if (lane == 0) h.out[m * h.CO + o] = (((__ldg(h.b4 + o) + s[0]) + s[1]) + s[2]) + s[3];
    }
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The tile: BN = 32, 64 or 128 output channels (the least that covers Cout,
// at most 128); BM = 128 pixels, or 64 where 128 would give fewer than two
// blocks an SM (the deep levels: 16^2 x 1024 at batch 8 gives 256 blocks of
// 64).
inline int tile_bn(int Cout) { return Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128; }
inline bool tile_wide(const ConvGeom& g, int bn) {
  return (long long)((g.M + 127) / 128) * ((g.Cout + bn - 1) / bn) >= 2LL * sm_count();
}

template <typename E, int BM, int BN>
cudaError_t launch_igemm(const E* x, const E* w, const float* bias, E* y, E* pooled,
                         const ConvGeom& g, cudaStream_t stream) {
  using T = ConvTile<E, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_igemm<E, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M + BM - 1) / BM, (g.Cout + BN - 1) / BN);
  const bool vec_a = g.Cin % T::kVec == 0 && aligned16(x);
  const bool vec_b = g.Cout % T::kVec == 0 && aligned16(w);
  conv3x3_igemm<E, BM, BN><<<grid, T::kT, T::kSmem, stream>>>(x, w, bias, y, pooled, g,
                                                              vec_a, vec_b);
  return cudaGetLastError();
}

template <typename E, int BM, int BN>
cudaError_t launch_head(const E* x, const E* w, const float* bias, const ConvGeom& g,
                        const DecoderHead<E>& h, cudaStream_t stream) {
  using T = ConvTile<E, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_head_igemm<E, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const bool vec_a = g.Cin % T::kVec == 0 && aligned16(x);
  const bool vec_b = g.Cout % T::kVec == 0 && aligned16(w);
  conv3x3_head_igemm<E, BM, BN><<<(g.M + BM - 1) / BM, T::kT, T::kSmem, stream>>>(
      x, w, bias, g, vec_a, vec_b, h);
  return cudaGetLastError();
}

// conv3x3(x, w) + bias, through a ReLU where relu is set, -> y (B, H, W,
// Cout) and, when pooled is not null, its 2x2 max pool -> pooled (B, H/2,
// W/2, Cout) (H, W even; the pool only after a ReLU). E is float or bf16,
// deduced from x (so that pooled may be nullptr).
template <typename E>
struct Same {
  using type = E;
};

template <typename E>
cudaError_t conv3x3_bias(const E* x, const E* w, const float* bias, E* y,
                         typename Same<E>::type* pooled, int B, int H, int W, int Cin, int Cout,
                         bool relu, cudaStream_t stream) {
  if (pooled != nullptr && (!relu || H % 2 || W % 2)) return cudaErrorInvalidValue;
  const ConvGeom g = {B, H, W, Cin, Cout, B * H * W, pooled != nullptr, relu};
  const int bn = tile_bn(Cout);
  const bool wide = tile_wide(g, bn);
#define T2H_IGEMM(BM, BN) launch_igemm<E, BM, BN>(x, w, bias, y, pooled, g, stream)
  if (bn == 32) return wide ? T2H_IGEMM(128, 32) : T2H_IGEMM(64, 32);
  if (bn == 64) return wide ? T2H_IGEMM(128, 64) : T2H_IGEMM(64, 64);
  return wide ? T2H_IGEMM(128, 128) : T2H_IGEMM(64, 128);
#undef T2H_IGEMM
}

// The decoder head over [h.x0, h.x1, h.x2, relu(conv3x3(x, w) + bias)] ->
// h.out (B, H, W, h.CO); x3 = the relu'd conv (Cout <= 64 channels, one
// block column; the model's is 64) is never written.
template <typename E>
cudaError_t conv3x3_head(const E* x, const E* w, const float* bias, int B, int H, int W,
                         int Cin, int Cout, const DecoderHead<E>& h, cudaStream_t stream) {
  if (Cout > 64) return cudaErrorInvalidValue;
  const ConvGeom g = {B, H, W, Cin, Cout, B * H * W, false, true};
  return tile_wide(g, 64) ? launch_head<E, 128, 64>(x, w, bias, g, h, stream)
                          : launch_head<E, 64, 64>(x, w, bias, g, h, stream);
}

}  // namespace t2h
