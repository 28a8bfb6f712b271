// The bilinear sample's corner math, shared by the level kernels (K4
// level.cu and level_bf16.cu, K5 level_bwd.cu) and the tile gather (K9
// tile_gather.cu):
// grid_sample on an R x R plane with the border clamp and align_corners=True
// (tomosar2height_tpu_torch/ops/sampling.py). A normalized coordinate u in
// [0, 1] maps to pixel u * (R - 1), clamped to the plane; the +1 neighbour of
// the last pixel is clamped onto it, where its weight is exactly 0.
#pragma once

#include "dtype.cuh"

namespace t2h {

struct Corner {
  int x0, y0;  // top-left pixel
  int dx, dy;  // 1 if the x+1 / y+1 neighbour lies inside the plane, else 0
  float wx, wy;  // weights of the +1 neighbours
};

__device__ __forceinline__ Corner bilinear_corner(float u, float v, int R) {
  const float rmax = static_cast<float>(R - 1);
  const float x = fminf(fmaxf(u * rmax, 0.0f), rmax);
  const float y = fminf(fmaxf(v * rmax, 0.0f), rmax);
  Corner c;
  c.x0 = min(max(static_cast<int>(floorf(x)), 0), R - 1);
  c.y0 = min(max(static_cast<int>(floorf(y)), 0), R - 1);
  c.wx = x - static_cast<float>(c.x0);
  c.wy = y - static_cast<float>(c.y0);
  c.dx = c.x0 + 1 < R ? 1 : 0;
  c.dy = c.y0 + 1 < R ? 1 : 0;
  return c;
}

// The sample of channel ch of an NHWC plane p (R x R x F, one batch entry).
__device__ __forceinline__ float bilinear_at(const float* __restrict__ p, const Corner& c,
                                             int R, int F, int ch) {
  const long long o = ((long long)c.y0 * R + c.x0) * F + ch;
  const long long ox = (long long)c.dx * F;
  const long long oy = (long long)c.dy * R * F;
  const float top = p[o] * (1.0f - c.wx) + p[o + ox] * c.wx;
  const float bot = p[o + oy] * (1.0f - c.wx) + p[o + oy + ox] * c.wx;
  return top * (1.0f - c.wy) + bot * c.wy;
}

// The four corner weights, (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1,
// y0 + 1), each cut to bf16: the bf16 rule of K4 and K5
// (level_kernel.py:234-245, level_bwd_kernel.py:214).
__device__ __forceinline__ void cut_weights(const Corner& c, float (&w)[4]) {
  const float ax = 1.0f - c.wx, ay = 1.0f - c.wy;
  w[0] = round_as<bf16>(ax * ay);
  w[1] = round_as<bf16>(c.wx * ay);
  w[2] = round_as<bf16>(ax * c.wy);
  w[3] = round_as<bf16>(c.wx * c.wy);
}

// The bf16 sample of channel ch: the cut weights times the bf16 corner
// values (exact in f32), summed in f32 in the corner order above, rounded
// to bf16 once (returned as its f32 value).
__device__ __forceinline__ float bilinear_at(const bf16* __restrict__ p, const Corner& c,
                                             int R, int F, int ch) {
  const long long o = ((long long)c.y0 * R + c.x0) * F + ch;
  const long long ox = (long long)c.dx * F;
  const long long oy = (long long)c.dy * R * F;
  float w[4];
  cut_weights(c, w);
  float s = w[0] * to_f32(p[o]);
  s += w[1] * to_f32(p[o + ox]);
  s += w[2] * to_f32(p[o + oy]);
  s += w[3] * to_f32(p[o + oy + ox]);
  return round_as<bf16>(s);
}

}  // namespace t2h
