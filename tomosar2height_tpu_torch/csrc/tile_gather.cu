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
// the work is (row, 16-byte chunk) items: a lane loads a chunk of each of the
// four corners as one 16-byte load (8 bf16 or 4 f32 features), so a row of F
// features takes F * size / 16 lanes (tile_plan.tile_gather_plan, mirrored by
// gather_plan below). A warp owns 32 rows: lane r loads row r's coordinates,
// beside the batch entry's last tile offset, and computes its corner once;
// then the warp takes the rows' items in steps, one item a lane in bf16 (its
// four 16-byte corner loads in flight; 8 rows a step at F = 32) and two in
// f32, each item's corner spread from its row's lane by shuffles. So the
// loads from device memory that a row's samples wait on (the coordinates,
// the offset) are paid once a warp, not once a row: at the coarse levels,
// where the plane stays in L1 and L2, a step then waits only on those
// caches. Past 32 chunks a row (F = 512 in bf16) a row takes 32 lanes and
// the warp walks its rows once a group of 32 chunks. (Measured on the H100:
// a warp a row, or two bf16 items a lane, lose at F = 512: more lines in
// flight than L1 keeps; tools/time_scatter.py.) Rows are Morton-ordered
// inside each 16x16 tile, so a warp's rows touch neighbouring pixels.
//
// Bound on the H100: bytes. Each output (B*N*F values) is written once and
// the plane and the coordinates read once: at the flagship's 256^2 level with
// F=64 (B=8, ~33k rows each) ~68 MB written and 134 MB of plane in f32,
// ~60 us at 3.35 TB/s.
//
// bf16 (the model's bf16 dtype): the kernel is templated on the element type
// V (dtype.cuh). A bf16 instance reads the bf16 plane, cuts the four bilinear
// weights to bf16, sums the four exact products in f32 in corner order and
// rounds each output to bf16 once (bilinear.cuh's cut_mix): the JAX kernel's
// rule with a bf16 plane, where the one-hot weight matrix is cast to the
// plane's dtype and contracted into f32 (gather_kernel.py:174-186), the f32
// coordinates as they are. The coordinates stay f32; the plane's and the
// output's bytes halve. Each feature's arithmetic is the one of the warp-a-row
// kernel this replaced (bilinear_at), so the outputs are the same bits.

#include "bilinear.cuh"
#include "common.cuh"

namespace t2h {

constexpr int kGatherWarps = kThreads / 32;
constexpr int kGatherRows = 32;  // rows a warp: one a lane for the corners
constexpr int kGatherLanes = 32;  // lanes a row at most, past 32 chunks a row

// The row -> lane map at width F for elements of `elem` bytes (the plane and
// the output 16-byte aligned or not): vec features a lane's chunk (16 bytes,
// or one feature where F is no multiple of 16 / elem or a pointer is
// unaligned), cpr chunks a row, lpr lanes a row (cpr up to 32; past it the
// largest power of two up to kGatherLanes that divides cpr), items a lane
// at once (their 4 x vec corner values in flight: one at vec = 8, else
// two), kGatherRows rows a warp taken in steps of 32 x items items, rows a
// block. Item e is lane e % lpr of row (e / lpr) % 32 in chunk group
// e / (32 lpr): chunk (e / (32 lpr)) lpr + e % lpr.
// tile_plan.tile_gather_plan.
struct GatherPlan {
  int vec, cpr, lpr, items, rows, steps, block_rows;
};

inline GatherPlan gather_plan(int F, int elem, bool aligned) {
  GatherPlan p;
  p.vec = aligned && F % (16 / elem) == 0 ? 16 / elem : 1;
  p.cpr = F / p.vec;
  p.lpr = p.cpr;
  if (p.cpr > 32)
    for (p.lpr = kGatherLanes; p.cpr % p.lpr != 0;) p.lpr /= 2;
  p.rows = kGatherRows;
  p.items = p.vec == 8 ? 1 : 2;
  p.steps = (kGatherRows * p.cpr + 32 * p.items - 1) / (32 * p.items);
  p.block_rows = kGatherRows * kGatherWarps;
  return p;
}

// The sample of one chunk from its four corners' chunks.
template <typename V, int VEC>
__device__ __forceinline__ Pack<V, VEC> sample_chunk(const Pack<V, VEC> (&c)[4], float wx,
                                                     float wy) {
  Pack<V, VEC> r;
  if constexpr (kIsBf16<V>) {
    float w[4];
    cut_weights(wx, wy, w);
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      r.v[t] = from_f32<V>(cut_mix(w, to_f32(c[0].v[t]), to_f32(c[1].v[t]), to_f32(c[2].v[t]),
                                   to_f32(c[3].v[t])));
  } else {
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      r.v[t] = bilinear_mix(c[0].v[t], c[1].v[t], c[2].v[t], c[3].v[t], wx, wy);
  }
  return r;
}

// A warp: rows [i0, i0 + 32) of batch entry blockIdx.y. Lane r loads row i0 +
// r's coordinates (lane 0 the entry's last tile offset beside them) and
// computes its corner; item e (gather_plan's map: row (e / lpr) % 32) takes
// its row's corner from that row's lane, U items a lane at once. Three
// blocks an SM (<= 80 registers).
template <typename V, int VEC, int U>
__global__ void __launch_bounds__(kThreads, 3)
tile_gather_lanes(const V* __restrict__ plane, const float* __restrict__ xy,
                  const int* __restrict__ toff, V* __restrict__ out, int N, int R, int F,
                  int T, int cpr, int lpr) {
  using P = Pack<V, VEC>;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i0 = (blockIdx.x * kGatherWarps + (threadIdx.x >> 5)) * kGatherRows;
  if (i0 >= N) return;  // warp-uniform
  const long long p = (long long)b * N + i0 + lane;
  const int lt = lane == 0 ? toff[(long long)b * (T + 1) + T] : 0;
  const bool in = i0 + lane < N;
  const float u = in ? xy[2 * p] : 0.0f;
  const float v = in ? xy[2 * p + 1] : 0.0f;
  const int last = __shfl_sync(kFull, lt, 0);
  const Corner c = bilinear_corner(u, v, R);  // unused past N and past last
  const int pix = c.y0 * R + c.x0;
  const int dxy = c.dx | c.dy << 1;
  const V* pl = plane + (long long)b * R * R * F;
  V* ob = out + ((long long)b * N + i0) * F;
  const int rows = min(kGatherRows, N - i0);
  const int items = kGatherRows * cpr;
  for (int e0 = 0; e0 < items; e0 += 32 * U) {
    P v[U][4];
    int row[U], k[U];
    bool sampled[U];
    float iwx[U], iwy[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every item's corner loads first
      const int e = e0 + 32 * u + lane;
      const int h = e / lpr;  // 32 * chunk group + row
      const int r = h & (kGatherRows - 1);
      row[u] = e < items && r < rows ? r : -1;
      const int q = __shfl_sync(kFull, pix, r);
      const int d = __shfl_sync(kFull, dxy, r);
      iwx[u] = __shfl_sync(kFull, c.wx, r);
      iwy[u] = __shfl_sync(kFull, c.wy, r);
      k[u] = ((h / kGatherRows) * lpr + e - h * lpr) * VEC;
      sampled[u] = row[u] >= 0 && i0 + row[u] < last;
      if (sampled[u]) {
        const long long o = (long long)q * F + k[u];
        const long long ox = d & 1 ? F : 0;
        const long long oy = d & 2 ? (long long)R * F : 0;
        v[u][0] = *reinterpret_cast<const P*>(pl + o);
        v[u][1] = *reinterpret_cast<const P*>(pl + o + ox);
        v[u][2] = *reinterpret_cast<const P*>(pl + o + oy);
        v[u][3] = *reinterpret_cast<const P*>(pl + o + oy + ox);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (row[u] < 0) continue;
      P r;
      if (sampled[u]) {
        r = sample_chunk<V, VEC>(v[u], iwx[u], iwy[u]);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) r.v[t] = from_f32<V>(0.0f);
      }
      *reinterpret_cast<P*>(ob + (long long)row[u] * F + k[u]) = r;
    }
  }
}

template <typename V>
int launch_tile_gather(const V* plane, const float* xy, const int* toff, V* out, int B,
                       int N, int R, int F, int T, cudaStream_t stream) {
  if ((long long)B * N * F <= 0) return static_cast<int>(cudaGetLastError());
  const GatherPlan p = gather_plan(F, sizeof(V), aligned16(plane) && aligned16(out));
  const dim3 grid((N + p.block_rows - 1) / p.block_rows, B);
  constexpr int kVec = 16 / sizeof(V);
  if (p.vec == 1)
    tile_gather_lanes<V, 1, 2><<<grid, kThreads, 0, stream>>>(plane, xy, toff, out, N, R, F, T,
                                                               p.cpr, p.lpr);
  else
    tile_gather_lanes<V, kVec, kVec == 8 ? 1 : 2><<<grid, kThreads, 0, stream>>>(
        plane, xy, toff, out, N, R, F, T, p.cpr, p.lpr);
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

// The launch's plan at width F (F > 0) for elements of `elem` bytes, the
// pointers 16-byte aligned or not: vec, cpr, lpr, rows, steps, block_rows to
// out[0..5].
int t2h_tile_gather_plan(int F, int elem, int aligned, int* out) {
  const GatherPlan p = gather_plan(F, elem, aligned != 0);
  const int v[] = {p.vec, p.cpr, p.lpr, p.items, p.rows, p.steps, p.block_rows};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
