// The bilinear sample's corner math, shared by the level kernels (K4
// level.cu, K5 level_bwd.cu) and the tile gather (K9 tile_gather.cu):
// grid_sample on an R x R plane with the border clamp and align_corners=True
// (tomosar2height_tpu_torch/ops/sampling.py). A normalized coordinate u in
// [0, 1] maps to pixel u * (R - 1), clamped to the plane; the +1 neighbour of
// the last pixel is clamped onto it, where its weight is exactly 0.
#pragma once

#include "common.cuh"

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

}  // namespace t2h
