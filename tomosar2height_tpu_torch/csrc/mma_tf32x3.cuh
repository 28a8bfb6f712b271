// The tensor-core GEMM core of the port's 3xTF32 kernels (K4 level.cu, K5's
// row pass and weight-gradient reduction in level_bwd.cu, K7's implicit-GEMM
// convs in igemm_conv.cuh): warp-level mma.sync.m16n8k8 TF32 products at
// fp32 accuracy (3xTF32), fragments loaded from padded shared tiles, a
// warp's 32-row block product (warp_mma), and the cp.async copies that fill
// those tiles.
//
// 3xTF32: each fp32 operand x splits in registers into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (x - hi is exact in fp32; split_tf32). The product a*b is taken
// as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, small terms first, into one fp32
// accumulator; the dropped lo_a*lo_b is ~2^-22 of |a*b|. One TF32 pass
// alone keeps ~11 bits and misses K4's 1e-5 tolerance
// (tests/test_torch_tf32x3.py emulates both on the CPU).
//
// The tensor cores add each MMA's products to its accumulator with
// truncation, at the accumulator's exponent: chained over a long K (K4's
// 1280 at F = 512), those one-sided errors added up to 3e-5 - 9e-5 of |o|
// on the card, beyond K4's 1e-5. So a few k8 steps' MMAs at a time (1-4)
// chain into a zeroed accumulator whose sum joins the running fp32
// accumulator by a rounded FADD (add4): the truncations then stay at the
// scale of those steps' sum.
//
// mma.sync and not wgmma: a TF32 wgmma takes both operands K-major from
// shared memory (transposition exists only for 16-bit types), while the
// reduction's operands are row-major scratch, M-major in their contraction
// dimension. mma.sync loads its fragments with plain shared loads in any
// layout. Fragment layouts of m16n8k8 (.row.col, tf32), g = lane / 4,
// t = lane % 4:
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (t, g), b1 (t + 4, g)              [(k, n)]
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Bank-conflict-free shared strides: a row-major A (element (i, k) at
// i * ld + k) wants ld = 4 (mod 32); a column-major A (at k * ld + i) and a
// B (element (k, n) at k * ld + n) want ld = 8 (mod 32).
#pragma once

#include "common.cuh"

namespace t2h {

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = cvt.rna.tf32.f32(x), lo = cvt.rna.tf32.f32(x - hi), written as
// integer ops on the bits: adding half a TF32 ulp (0x1000) to the magnitude
// bits and dropping the low 13 rounds to nearest, ties away from zero, as
// cvt.rna does for every finite x. The instruction itself adds a NaN/Inf
// test and a select per value (6-7 SASS instructions a split, against 4
// here); the kernels' operands are finite. hi is masked (x - hi must be
// exact); lo keeps its low 13 bits, which the MMA ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at fp32 accuracy (in the tensor cores' accumulation): lo*hi,
// hi*lo, then hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d += s, rounded to nearest: a chain of MMAs joins the running accumulator.
__device__ __forceinline__ void add4(float (&d)[4], const float (&s)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

__device__ __forceinline__ void split4(FragA& f, float x0, float x1, float x2, float x3) {
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  split_tf32(x2, f.hi[2], f.lo[2]);
  split_tf32(x3, f.hi[3], f.lo[3]);
}

// The 16 x 8 A fragment whose (0, 0) element is at p; row-major, stride ld.
__device__ __forceinline__ void load_a_row(FragA& f, const float* p, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* q = p + g * ld + t;
  split4(f, q[0], q[8 * ld], q[4], q[8 * ld + 4]);
}

// The same from a column-major tile (element (i, k) at p[k * ld + i]).
__device__ __forceinline__ void load_a_col(FragA& f, const float* p, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* q = p + t * ld + g;
  split4(f, q[0], q[8], q[4 * ld], q[4 * ld + 8]);
}

// The 8 x 8 B fragment whose (0, 0) element is at p (element (k, n) at
// p[k * ld + n]).
__device__ __forceinline__ void load_b(FragB& f, const float* p, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* q = p + t * ld + g;
  split_tf32(q[0], f.hi[0], f.lo[0]);
  split_tf32(q[4 * ld], f.hi[1], f.lo[1]);
}

// acc (a warp's 32 rows x 8*NT columns) += A[rows wm.., KS columns] @
// W[KS rows][columns wc..]: A row-major in shared (stride lda), W a staged
// tile (stride ldw). Two k8 steps chain in the tensor cores per rounded
// add. With Clip, n-tiles whose first column (wc + 8 nt) is nlim or more
// are skipped.
template <int KS, int NT, bool Clip = false>
__device__ __forceinline__ void warp_mma(float (&acc)[2][NT][4], const float* A, int lda,
                                         const float* W, int ldw, int wm, int wc, int lane,
                                         int nlim = 1 << 30) {
  static_assert(KS % 16 == 0, "tiles hold pairs of k8 steps");
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    FragA a[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a_row(a[f][mt], A + (wm + 16 * mt) * lda + kk + 8 * f, lda, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (Clip && wc + 8 * nt >= nlim) continue;
      FragB bf[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) load_b(bf[f], W + (kk + 8 * f) * ldw + wc + nt * 8, ldw, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma3(s, a[0][mt], bf[0]);
        mma3(s, a[1][mt], bf[1]);
        add4(acc[mt][nt], s);
      }
    }
  }
}

// --- cp.async ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + TR) x columns [c0, c0 + TC) of a row-major global matrix g
// (row stride ld; rows < rmax and columns < cmax exist) -> s (row stride
// sld), zero where the matrix has no element. vec: 16-byte copies, which
// needs ld, c0 and cmax multiples of 16 / sizeof(E) and g 16-byte aligned;
// else element copies: cp.async of 4 bytes for fp32, and loads through
// registers for 2-byte elements (cp.async copies 4, 8 or 16 bytes). Every
// one of the block's NTH threads calls it.
template <int TR, int TC, int NTH = kThreads, typename E>
__device__ __forceinline__ void cp_tile(E* s, int sld, const E* __restrict__ g, long long ld,
                                        long long r0, long long rmax, int c0, int cmax,
                                        bool vec, int tid) {
  if (vec) {
    constexpr int kV = 16 / sizeof(E);
    constexpr int kCh = TC / kV;
#pragma unroll
    for (int e = tid; e < TR * kCh; e += NTH) {
      const int r = e / kCh;
      const int c = (e - r * kCh) * kV;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async16(s + r * sld + c, ok ? g + (r0 + r) * ld + c0 + c : g, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TR * TC; e += NTH) {
      const int r = e / TC;
      const int c = e - r * TC;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      if constexpr (sizeof(E) == 4) {
        cp_async4(s + r * sld + c, ok ? g + (r0 + r) * ld + c0 + c : g, ok ? 4 : 0);
      } else {
        static_assert(sizeof(E) == 2, "4- or 2-byte elements");
        reinterpret_cast<unsigned short*>(s)[r * sld + c] =
            ok ? reinterpret_cast<const unsigned short*>(g)[(r0 + r) * ld + c0 + c] : 0;
      }
    }
  }
}

}  // namespace t2h
