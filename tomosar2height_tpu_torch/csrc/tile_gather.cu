// Bilinear sample of a plane at Morton-aligned points: the Hopper version of
// _gather_kernel in tomosar2height_tpu/ops/pallas/gather_kernel.py (launched by
// _tile_gather_impl; pallas_tile_gather, the ALTO round trips' sample under
// sorted_impl='fused').
//
// The function: grid_sample of the (B,R,R,F) NHWC plane at each row's
// normalized xy with the border clamp and align_corners=True (the corner math
// of bilinear.cuh, shared with K4 and K5), for every row of the tiles' ranges
// [0, toff[T]). Rows past the last tile's range, which the TPU kernel leaves
// undefined, are written 0. Pad rows inside a tile's range (coordinates 0.5)
// are sampled like any row and left for the wrapper's mask, as in
// tomosar2height_tpu/ops/pallas/fused.py:56-57.
//
// The TPU kernel DMAs each 16x16 tile's 18 x 32-pixel window into VMEM and
// samples a 128-row chunk as one matmul with a 4-nonzero weight matrix. Here
// a warp samples one row: its lanes take 32 consecutive features at a time,
// so each corner read is a 128-byte line, and the tile's window stays in
// L1/L2 while its rows (contiguous in Morton order) are sampled. The row's
// corner is computed once per lane, with no 64-bit division.
//
// Bound on the H100: bytes. Each output (B*N*F floats) is written once and
// the plane and the coordinates read once: at the flagship's 256^2 level with
// F=64 (B=8, ~33k rows each) ~68 MB written and 134 MB of plane, ~60 us at
// 3.35 TB/s.
//
// bf16 (the model's bf16 dtype): the kernel is templated on the element type
// V (dtype.cuh). A bf16 instance reads the bf16 plane (a warp's corner read
// is a 64-byte line), cuts the four bilinear weights to bf16, sums the four
// exact products in f32 in corner order and rounds each output to bf16 once
// (bilinear.cuh's bf16 bilinear_at): the JAX kernel's rule with a bf16
// plane, where the one-hot weight matrix is cast to the plane's dtype and
// contracted into f32 (gather_kernel.py:174-186), the f32 coordinates as
// they are. The coordinates stay f32; the plane's and the output's bytes
// halve.

#include "bilinear.cuh"
#include "common.cuh"

namespace t2h {

constexpr int kGatherRows = kThreads / 32;  // rows per block, one per warp

template <typename V>
__global__ void __launch_bounds__(kThreads)
tile_gather_kernel(const V* __restrict__ plane, const float* __restrict__ xy,
                   const int* __restrict__ toff, V* __restrict__ out, int N, int R,
                   int F, int T) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kGatherRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= N) return;
  const long long p = (long long)b * N + i;
  V* o = out + p * F;
  if (i >= toff[(long long)b * (T + 1) + T]) {
    for (int ch = lane; ch < F; ch += 32) o[ch] = from_f32<V>(0.0f);
    return;
  }
  const Corner c = bilinear_corner(xy[2 * p], xy[2 * p + 1], R);
  const V* pl = plane + (long long)b * R * R * F;
  for (int ch = lane; ch < F; ch += 32) o[ch] = from_f32<V>(bilinear_at(pl, c, R, F, ch));
}

template <typename V>
int launch_tile_gather(const V* plane, const float* xy, const int* toff, V* out, int B,
                       int N, int R, int F, int T, cudaStream_t stream) {
  if ((long long)B * N * F > 0) {
    const dim3 grid((N + kGatherRows - 1) / kGatherRows, B);
    tile_gather_kernel<V><<<grid, kThreads, 0, stream>>>(plane, xy, toff, out, N, R, F, T);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t2h

using namespace t2h;

extern "C" {

// plane (B,R,R,F) f32 NHWC, xy (B,N,2) f32 in [0,1], toff (B,T+1) i32 row
// offsets of the T tiles at this resolution -> out (B,N,F): the bilinear
// sample on rows [0, toff[b,T]), 0 past them.
int t2h_tile_gather(const float* plane, const float* xy, const int* toff, float* out,
                    int B, int N, int R, int F, int T, cudaStream_t stream) {
  return launch_tile_gather(plane, xy, toff, out, B, N, R, F, T, stream);
}

// The same on a bf16 plane and out: the weights cut to bf16, each sample's
// f32 sum rounded to bf16 once (JAX gather_kernel.py:174-186).
int t2h_tile_gather_bf16(const bf16* plane, const float* xy, const int* toff, bf16* out,
                         int B, int N, int R, int F, int T, cudaStream_t stream) {
  return launch_tile_gather(plane, xy, toff, out, B, N, R, F, T, stream);
}

}  // extern "C"
