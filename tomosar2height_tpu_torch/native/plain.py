"""The numpy plain versions of the C++ host runtime's entry points
(:mod:`tomosar2height_tpu_torch.native`), each bit-equal to it: the tests
hold the two to each other, and the loader and the generator take these
where they are built with ``native=False``. Each is the port's numpy path of
its call site (``geo/crop.py``, ``geo/transform.py``, ``geo/cloud.py``,
``ops/sorted_scatter.py``) or written here where the port has none.
"""

from __future__ import annotations

import numpy as np

from tomosar2height_tpu_torch.geo.cloud import load_las_as_numpy as las_read  # noqa: F401
from tomosar2height_tpu_torch.geo.crop import crop_pc_2d_index  # noqa: F401
from tomosar2height_tpu_torch.geo.transform import transform_points
from tomosar2height_tpu_torch.ops.sorted_scatter import (  # noqa: F401
    host_morton_bucket_aligned as morton_align,
)


def transform_points_f32(points: np.ndarray, m4: np.ndarray) -> np.ndarray:
    return transform_points(points, m4).astype(np.float32)


def recrop_f32(points: np.ndarray, norm_min, norm_max) -> np.ndarray:
    """The float32 points strictly inside (norm_min, norm_max) in x and y,
    the bounds cast to float32 (as numpy compares a float32 array with
    Python-float bounds)."""
    lo = [np.float32(v) for v in norm_min[:2]]
    hi = [np.float32(v) for v in norm_max[:2]]
    keep = ((points[:, 0] > lo[0]) & (points[:, 0] < hi[0])
            & (points[:, 1] > lo[1]) & (points[:, 1] < hi[1]))
    return points[keep]


def crop_transform_patch(points: np.ndarray, p_min, p_max, m4: np.ndarray,
                         norm_min, norm_max) -> np.ndarray:
    """World crop (strict, float64), transform, float32 cast, recrop."""
    p = np.asarray(points, dtype=np.float64)
    inside = p[crop_pc_2d_index(p, p_min, p_max)]
    return recrop_f32(transform_points_f32(inside, m4), norm_min, norm_max)


def bucket_points(points_xy: np.ndarray, reso: int):
    """(cells int32, order int64): cell = cx + reso * cy of the float32
    points, c = clip(trunc(coord * reso), 0, reso - 1) in float32, and the
    stable sort by cell."""
    p = np.asarray(points_xy, dtype=np.float32)
    c = np.clip((p[:, :2] * np.float32(reso)).astype(np.int64), 0, reso - 1)
    cells = (c[:, 0] + reso * c[:, 1]).astype(np.int32)
    return cells, np.argsort(cells, kind="stable").astype(np.int64)


def max_z_grid(points: np.ndarray, bl, tr, pixel) -> np.ndarray:
    """(rows, cols) float32 raster of the highest float32 z in each pixel,
    -inf where none; row 0 north."""
    p = np.asarray(points, dtype=np.float64)
    rows = int(np.floor((tr[1] - bl[1]) / pixel[1]))
    cols = int(np.floor((tr[0] - bl[0]) / pixel[0]))
    fc = np.floor((p[:, 0] - float(bl[0])) / float(pixel[0]))
    fr = np.floor((float(tr[1]) - p[:, 1]) / float(pixel[1]))
    ok = (fc >= 0) & (fc < cols) & (fr >= 0) & (fr < rows)
    grid = np.full(rows * cols, -np.inf, dtype=np.float32)
    flat = fr[ok].astype(np.int64) * cols + fc[ok].astype(np.int64)
    np.maximum.at(grid, flat, p[ok, 2].astype(np.float32))
    return grid.reshape(rows, cols)


def blend_accumulate(dsm: np.ndarray, weight: np.ndarray, patch: np.ndarray,
                     w: np.ndarray, row0: int, col0: int) -> None:
    """dsm += patch * w, weight += w in float64 over the window at (row0,
    col0), clipped to the scene."""
    ph, pw = patch.shape
    h, wd = dsm.shape
    r0, r1 = max(row0, 0), min(row0 + ph, h)
    c0, c1 = max(col0, 0), min(col0 + pw, wd)
    if r0 >= r1 or c0 >= c1:
        return
    ps = (slice(r0 - row0, r1 - row0), slice(c0 - col0, c1 - col0))
    ww = np.asarray(w, dtype=np.float64)[ps]
    dsm[r0:r1, c0:c1] += np.asarray(patch, dtype=np.float64)[ps] * ww
    weight[r0:r1, c0:c1] += ww


def blend_accumulate_batch(dsm: np.ndarray, weight: np.ndarray, patches: np.ndarray,
                           w: np.ndarray, rows0, cols0, valid, nthreads: int = 0) -> None:
    """:func:`blend_accumulate` of each valid tile, in batch order."""
    for i in np.nonzero(np.asarray(valid, dtype=bool))[0]:
        blend_accumulate(dsm, weight, patches[i], w, int(rows0[i]), int(cols0[i]))
