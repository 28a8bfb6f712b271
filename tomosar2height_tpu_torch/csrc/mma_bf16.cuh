// The bf16 tensor-core products of the port's bf16 kernels, the conv core
// (igemm_conv.cuh: K6, and K7's and K8's flat-K route) and K5's row pass
// (level_bwd.cu; K4, K5's weight sums and K7's and K8's other convs run on
// wgmma, wgmma_bf16.cuh): warp-level mma.sync.m16n8k16 with bf16 operands and
// fp32 accumulators, one pass where 3xTF32 (mma_tf32x3.cuh) makes three
// (989 TFLOP/s dense on the H100 against 495/3), fragments loaded from
// padded shared tiles with ldmatrix.
//
// Products of two bf16 values are exact in fp32, so the only rounding
// before the epilogue's is the accumulation's: ~2^-23 of the partial sum
// per add, far below the one rounding to bf16 (up to 2^-8 relative) that
// the output takes.
//
// Fragment layouts of m16n8k16 (.row.col, bf16), g = lane / 4, t = lane % 4,
// each register a pair of bf16 values (the lower index in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t + 8..2t + 9, g)          [(k, n)]
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values, lanes 8j..8j+7
// giving the addresses of matrix j's eight rows (16 bytes each); lane l
// receives in register j the pair (row l / 4, columns 2 (l % 4)..) of
// matrix j, or with .trans the pair (rows 2 (l % 4).., column l / 4). So
// A's fragment is one ldmatrix of a row-major [m][k] tile (lanes 0-15 name
// rows 0-15 at column k, lanes 16-31 the same rows at k + 8), and two n8
// tiles of B are one ldmatrix.trans of a row-major [k][n] tile (lanes 0-15
// name rows k..k+15 at column n, lanes 16-31 the same rows at n + 8): the
// weights' HWIO rows as they lie in memory, copied as they are.
#pragma once

#include "dtype.cuh"
#include "mma_tf32x3.cuh"

namespace t2h {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (a warp's 32 rows x 8*NT columns) += A[rows wm.., KS columns] @
// B[KS rows][columns wn..]: A row-major in shared (stride lda), B row-major
// [k][n] in shared (stride ldb); both strides in elements, rows 16-byte
// aligned. n8 tiles go in pairs (one ldmatrix.x4.trans); an odd last one
// alone (x2: lanes 0-15 name its rows).
template <int KS, int NT>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[2][NT][4],
                                              const __nv_bfloat16* A, int lda,
                                              const __nv_bfloat16* B, int ldb, int wm, int wn,
                                              int lane) {
  static_assert(KS % 16 == 0, "k16 steps");
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], A + (wm + 16 * mt + (lane & 15)) * lda + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, B + (kk + (lane & 15)) * ldb + wn + 16 * np + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
    if constexpr (NT % 2 == 1) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, B + (kk + (lane & 15)) * ldb + wn + 8 * (NT - 1));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
    }
  }
}

// The same product for either element type: 3xTF32 from fp32 tiles
// (mma_tf32x3.cuh warp_mma, strides as it wants them), or one bf16 pass
// from bf16 tiles. K5's row pass takes it.
template <int KS, int NT, typename T>
__device__ __forceinline__ void warp_mma_t(float (&acc)[2][NT][4], const T* A, int lda,
                                           const T* B, int ldb, int wm, int wn, int lane) {
  if constexpr (kIsBf16<T>) {
    warp_mma_bf16<KS, NT>(acc, A, lda, B, ldb, wm, wn, lane);
  } else {
    warp_mma<KS, NT>(acc, A, lda, B, ldb, wm, wn, lane);
  }
}

}  // namespace t2h
