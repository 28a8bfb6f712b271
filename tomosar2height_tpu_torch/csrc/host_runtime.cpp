// host_runtime: the port's C++ host runtime for the data path and the host
// blend. A plain C ABI loaded with ctypes (tomosar2height_tpu_torch/native),
// which releases the GIL for the length of every call, so the loader's
// worker threads and the serving loop's blend run beside each other.
//
// Entry points: the strict 2D bbox crop, the homogeneous point transform, the
// fused crop -> normalize -> recrop of a patch, the LAS reader, cell
// bucketing, the max-z raster, the weighted blend of one tile or of a batch
// (threads over disjoint row bands of the scene), and the chunk-aligned
// Morton layout. Each is bit-equal to its numpy plain version in
// tomosar2height_tpu_torch/native/plain.py: the library is built with
// -ffp-contract=off and without -ffast-math, and every sum is written in the
// order numpy evaluates it, so no product is fused into an add and no sum is
// reordered.
//
// Build: tomosar2height_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// -std=c++17 -pthread -ffp-contract=off), at first use, into _build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One row of a row-major 4x4 transform applied to (x, y, z, 1), summed left
// to right as numpy evaluates m0 * x + m1 * y + m2 * z + m3.
inline double row_dot(const double* m, double x, double y, double z) {
  return m[0] * x + m[1] * y + m[2] * z + m[3];
}

// True when the last row is (0, 0, 0, 1): w is 1 and the divide is skipped.
inline bool is_affine(const double* m4) {
  return m4[12] == 0.0 && m4[13] == 0.0 && m4[14] == 0.0 && m4[15] == 1.0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Strict 2D bbox crop: the ascending indices of the points with
// xmin < x < xmax and ymin < y < ymax. pts is (n, stride) row-major float64.
// Returns the number of hits written to out_idx (room for n).
int64_t t2h_crop_pc_2d(const double* pts, int64_t n, int64_t stride, double xmin,
                       double ymin, double xmax, double ymax, int64_t* out_idx) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * stride];
    const double y = pts[i * stride + 1];
    const bool in = (x > xmin) & (x < xmax) & (y > ymin) & (y < ymax);
    out_idx[k] = i;
    k += in;
  }
  return k;
}

// ---------------------------------------------------------------------------
// (n, 3) float64 points through a row-major 4x4 transform, cast to float32;
// divided by w where the last row is not (0, 0, 0, 1).
void t2h_transform_points_f32(const double* pts, int64_t n, const double* m4,
                              float* out) {
  const bool affine = is_affine(m4);
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
    double v0 = row_dot(m4, x, y, z);
    double v1 = row_dot(m4 + 4, x, y, z);
    double v2 = row_dot(m4 + 8, x, y, z);
    if (!affine) {
      const double w = row_dot(m4 + 12, x, y, z);
      v0 /= w;
      v1 /= w;
      v2 /= w;
    }
    out[i * 3] = static_cast<float>(v0);
    out[i * 3 + 1] = static_cast<float>(v1);
    out[i * 3 + 2] = static_cast<float>(v2);
  }
}

// ---------------------------------------------------------------------------
// The patch normalize in one pass: the points strictly inside the world bbox,
// transformed and cast to float32, kept where the float32 x and y lie
// strictly inside (nxmin, nxmax) x (nymin, nymax), the bounds given in
// float32 as numpy compares a float32 array with Python-float bounds.
// Writes (m, 3) float32 to out (room for n) and returns m.
int64_t t2h_crop_transform_patch(const double* pts, int64_t n, double xmin, double ymin,
                                 double xmax, double ymax, const double* m4, float nxmin,
                                 float nymin, float nxmax, float nymax, float* out) {
  const bool affine = is_affine(m4);
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
    if (!(x > xmin && x < xmax && y > ymin && y < ymax)) continue;
    double v0 = row_dot(m4, x, y, z);
    double v1 = row_dot(m4 + 4, x, y, z);
    double v2 = row_dot(m4 + 8, x, y, z);
    if (!affine) {
      const double w = row_dot(m4 + 12, x, y, z);
      v0 /= w;
      v1 /= w;
      v2 /= w;
    }
    const float nx = static_cast<float>(v0);
    const float ny = static_cast<float>(v1);
    if (!(nx > nxmin && nx < nxmax && ny > nymin && ny < nymax)) continue;
    out[k * 3] = nx;
    out[k * 3 + 1] = ny;
    out[k * 3 + 2] = static_cast<float>(v2);
    ++k;
  }
  return k;
}

// ---------------------------------------------------------------------------
// LAS 1.0-1.4 reader: the public header, then scale * int32 + offset of each
// record's x, y, z. Two calls: with out == nullptr it returns the point
// count, else it fills out (n, 3) float64 and returns n. Errors: -1 the file
// does not open, -2 no LAS magic or a short header or record, -3 a LAZ point
// format, -4 the point records are truncated, -5 a version other than
// 1.0-1.4.
int64_t t2h_las_read(const char* path, double* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char header[375];
  const size_t got = std::fread(header, 1, sizeof(header), f);
  if (got < 227 || std::memcmp(header, "LASF", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  auto rd_u16 = [&](size_t o) { uint16_t v; std::memcpy(&v, header + o, 2); return v; };
  auto rd_u32 = [&](size_t o) { uint32_t v; std::memcpy(&v, header + o, 4); return v; };
  auto rd_u64 = [&](size_t o) { uint64_t v; std::memcpy(&v, header + o, 8); return v; };
  auto rd_f64 = [&](size_t o) { double v; std::memcpy(&v, header + o, 8); return v; };

  const uint8_t ver_major = header[24], ver_minor = header[25];
  if (ver_major != 1 || ver_minor > 4) {
    std::fclose(f);
    return -5;
  }
  const uint32_t offset = rd_u32(96);
  const uint8_t point_format = header[104];
  if (point_format >= 128) {
    std::fclose(f);
    return -3;
  }
  const uint16_t record_len = rd_u16(105);
  uint64_t n = rd_u32(107);
  if (ver_minor >= 4 && n == 0) {
    if (got < 255) {
      std::fclose(f);
      return -2;
    }
    n = rd_u64(247);
  }
  if (n > 0 && record_len < 12) {
    std::fclose(f);
    return -2;
  }
  const double sx = rd_f64(131), sy = rd_f64(139), sz = rd_f64(147);
  const double ox = rd_f64(155), oy = rd_f64(163), oz = rd_f64(171);
  if (out == nullptr) {
    std::fclose(f);
    return static_cast<int64_t>(n);
  }
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -4;
  }
  std::vector<unsigned char> buf(static_cast<size_t>(n) * record_len);
  const size_t read = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (read < buf.size()) return -4;
  for (uint64_t i = 0; i < n; ++i) {
    int32_t xi, yi, zi;
    const unsigned char* rec = buf.data() + i * record_len;
    std::memcpy(&xi, rec, 4);
    std::memcpy(&yi, rec + 4, 4);
    std::memcpy(&zi, rec + 8, 4);
    out[i * 3] = xi * sx + ox;
    out[i * 3 + 1] = yi * sy + oy;
    out[i * 3 + 2] = zi * sz + oz;
  }
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// Cell ids of float32 points in the unit square, cell = cx + reso * cy with
// c = clip(trunc(float32(coord * reso)), 0, reso - 1), and the stable
// permutation that makes the cells non-decreasing (a counting sort).
// pts is (n, stride) float32.
void t2h_bucket_points(const float* pts, int64_t n, int64_t stride, int32_t reso,
                       int32_t* cells, int64_t* order) {
  const int64_t ncell = static_cast<int64_t>(reso) * reso;
  const float r = static_cast<float>(reso);
  std::vector<int64_t> count(ncell + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = static_cast<int64_t>(pts[i * stride] * r);
    int64_t cy = static_cast<int64_t>(pts[i * stride + 1] * r);
    cx = std::min<int64_t>(std::max<int64_t>(cx, 0), reso - 1);
    cy = std::min<int64_t>(std::max<int64_t>(cy, 0), reso - 1);
    const int32_t c = static_cast<int32_t>(cx + reso * cy);
    cells[i] = c;
    ++count[c + 1];
  }
  for (int64_t c = 0; c < ncell; ++c) count[c + 1] += count[c];
  for (int64_t i = 0; i < n; ++i) order[count[cells[i]]++] = i;
}

// ---------------------------------------------------------------------------
// Max-z raster: grid (rows, cols) float32, filled by the caller (-inf), row
// 0 north; the point at (x, y) lands in column floor((x - xmin) / px) and
// row floor((ymax - y) / py), its z cast to float32; points off the grid are
// skipped.
void t2h_max_z_grid(const double* pts, int64_t n, double xmin, double ymin, double xmax,
                    double ymax, double px, double py, float* grid, int64_t rows,
                    int64_t cols) {
  (void)ymin;
  (void)xmax;
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1];
    const double fc = std::floor((x - xmin) / px);
    const double fr = std::floor((ymax - y) / py);
    if (!(fc >= 0.0 && fc < static_cast<double>(cols) && fr >= 0.0 &&
          fr < static_cast<double>(rows)))
      continue;
    float& cell = grid[static_cast<int64_t>(fr) * cols + static_cast<int64_t>(fc)];
    const float z = static_cast<float>(pts[i * 3 + 2]);
    if (z > cell) cell = z;
  }
}

// ---------------------------------------------------------------------------
// Weighted accumulation of one tile into the scene rasters: dsm += patch * w,
// weight += w over the window at (row0, col0), clipped to the (H, W) scene.
// Everything float64; patch and w are (ph, pw).
void t2h_blend_accumulate(double* dsm, double* weight, int64_t H, int64_t W,
                          const double* patch, const double* w, int64_t ph, int64_t pw,
                          int64_t row0, int64_t col0) {
  for (int64_t r = 0; r < ph; ++r) {
    const int64_t rr = row0 + r;
    if (rr < 0 || rr >= H) continue;
    double* drow = dsm + rr * W;
    double* wrow = weight + rr * W;
    const double* prow = patch + r * pw;
    const double* wprow = w + r * pw;
    for (int64_t c = 0; c < pw; ++c) {
      const int64_t cc = col0 + c;
      if (cc < 0 || cc >= W) continue;
      drow[cc] += prow[c] * wprow[c];
      wrow[cc] += wprow[c];
    }
  }
}

// ---------------------------------------------------------------------------
// A batch of tiles in one call: threads own disjoint row bands of the scene
// (tiles overlap one another, bands do not), and each walks the batch in
// order, so every pixel adds its tiles in batch order, as the per-tile loop.
// patches is (B, ph, pw) float64; w the shared (ph, pw) weight; valid[b] == 0
// skips tile b.
void t2h_blend_accumulate_batch(double* dsm, double* weight, int64_t H, int64_t W,
                                const double* patches, const double* w, int64_t B,
                                int64_t ph, int64_t pw, const int64_t* rows0,
                                const int64_t* cols0, const uint8_t* valid,
                                int64_t nthreads) {
  nthreads = std::max<int64_t>(1, std::min<int64_t>(nthreads, H));
  auto work = [&](int64_t band_lo, int64_t band_hi) {
    for (int64_t b = 0; b < B; ++b) {
      if (!valid[b]) continue;
      const int64_t r0 = rows0[b], c0 = cols0[b];
      const int64_t rlo = std::max(band_lo, std::max<int64_t>(r0, 0));
      const int64_t rhi = std::min(band_hi, std::min(H, r0 + ph));
      const int64_t clo = std::max<int64_t>(c0, 0);
      const int64_t chi = std::min(W, c0 + pw);
      if (clo >= chi) continue;
      const double* pbase = patches + b * ph * pw;
      for (int64_t rr = rlo; rr < rhi; ++rr) {
        const double* prow = pbase + (rr - r0) * pw;
        const double* srow = w + (rr - r0) * pw;
        double* drow = dsm + rr * W;
        double* wrow = weight + rr * W;
        for (int64_t cc = clo; cc < chi; ++cc) {
          drow[cc] += prow[cc - c0] * srow[cc - c0];
          wrow[cc] += srow[cc - c0];
        }
      }
    }
  };
  if (nthreads <= 1) {
    work(0, H);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t band = (H + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    const int64_t lo = t * band;
    const int64_t hi = std::min(H, lo + band);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// The chunk-aligned Morton tile layout (ops/sorted_scatter.py
// host_morton_bucket_aligned): cell = Morton interleave of
// clip(trunc(float32(coord * reso)), 0, reso - 1) (x in the even bits), the
// valid points stably sorted by cell, each tile's run of tile_cells cells
// padded to a multiple of chunk; pad rows (0.5, 0.5, 0.5) with cell
// pad_cell_sentinel and mask 0. pts is (n, 3) float32; mask (n) uint8, or
// nullptr where every point is valid. Writes out_pts (npad, 3), out_mask
// (npad), out_cells (npad) and out_toff (reso^2 / tile_cells + 1). Returns
// the rows used (out_toff's last entry), or -1 where they pass npad.
int64_t t2h_morton_align(const float* pts, const uint8_t* mask, int64_t n, int32_t reso,
                         int32_t chunk, int32_t tile_cells, int64_t npad,
                         int32_t pad_cell_sentinel, float* out_pts, uint8_t* out_mask,
                         int32_t* out_cells, int32_t* out_toff) {
  int bits = 0;
  while ((int64_t{1} << (bits + 1)) <= reso) ++bits;
  const int64_t ncell = static_cast<int64_t>(reso) * reso;
  const int64_t ntiles = ncell / tile_cells;
  const float r = static_cast<float>(reso);

  std::vector<int32_t> code(static_cast<size_t>(n));
  std::vector<int64_t> cell_count(static_cast<size_t>(ncell), 0);
  for (int64_t i = 0; i < n; ++i) {
    if (mask != nullptr && !mask[i]) {
      code[i] = -1;
      continue;
    }
    int64_t xi = static_cast<int64_t>(pts[i * 3] * r);
    int64_t yi = static_cast<int64_t>(pts[i * 3 + 1] * r);
    xi = std::min<int64_t>(std::max<int64_t>(xi, 0), reso - 1);
    yi = std::min<int64_t>(std::max<int64_t>(yi, 0), reso - 1);
    int32_t c = 0;
    for (int b = 0; b < bits; ++b) {
      c |= static_cast<int32_t>(((xi >> b) & 1) << (2 * b));
      c |= static_cast<int32_t>(((yi >> b) & 1) << (2 * b + 1));
    }
    code[i] = c;
    ++cell_count[c];
  }
  std::vector<int64_t> cell_pos(static_cast<size_t>(ncell));
  int64_t astart = 0;
  for (int64_t t = 0; t < ntiles; ++t) {
    out_toff[t] = static_cast<int32_t>(astart);
    int64_t pos = astart, cnt = 0;
    for (int64_t c = t * tile_cells; c < (t + 1) * tile_cells; ++c) {
      cell_pos[c] = pos;
      pos += cell_count[c];
      cnt += cell_count[c];
    }
    astart += ((cnt + chunk - 1) / chunk) * chunk;
    if (astart > npad) return -1;
  }
  out_toff[ntiles] = static_cast<int32_t>(astart);
  for (int64_t i = 0; i < npad; ++i) {
    out_pts[i * 3] = 0.5f;
    out_pts[i * 3 + 1] = 0.5f;
    out_pts[i * 3 + 2] = 0.5f;
    out_mask[i] = 0;
    out_cells[i] = pad_cell_sentinel;
  }
  // the stable scatter: each cell keeps its points in input order, as
  // numpy's stable argsort
  for (int64_t i = 0; i < n; ++i) {
    if (code[i] < 0) continue;
    const int64_t d = cell_pos[code[i]]++;
    out_pts[d * 3] = pts[i * 3];
    out_pts[d * 3 + 1] = pts[i * 3 + 1];
    out_pts[d * 3 + 2] = pts[i * 3 + 2];
    out_mask[d] = 1;
    out_cells[d] = code[i];
  }
  return astart;
}

const char* t2h_host_runtime_version() { return "t2h host runtime 1"; }

}  // extern "C"
