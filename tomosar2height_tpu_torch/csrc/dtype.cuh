// The element types of the port's kernels: float, or bf16 under the model's
// bf16 dtype. A kernel templated on T loads its values into float
// registers, computes in float, and rounds to T where it stores (and where
// its JAX kernel rounds): for T = float every helper here is the identity,
// so a float instance runs the arithmetic it ran before it was templated.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace t2h {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// v in T: itself, or rounded to the nearest bf16 (ties to even)
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// v rounded to T and back: where a bf16 JAX kernel casts an f32 result to
// its dtype (a product's sum, a bias add); the identity for float
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  return to_f32(from_f32<T>(v));
}

// VEC consecutive values of a row (VEC * sizeof(T) bytes, aligned to that)
// loaded into float registers as one vector, and stored back from them.
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&r)[VEC]) {
  if constexpr (kIsBf16<T>) {
    if constexpr (VEC == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      r[0] = lo.x, r[1] = lo.y, r[2] = hi.x, r[3] = hi.y;
    } else if constexpr (VEC == 2) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      r[0] = v.x, r[1] = v.y;
    } else {
      r[0] = __bfloat162float(*p);
    }
  } else if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&r)[VEC]) {
  if constexpr (kIsBf16<T>) {
    if constexpr (VEC == 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(r[0], r[1]);
    } else {
      *p = __float2bfloat16_rn(r[0]);
    }
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

}  // namespace t2h
