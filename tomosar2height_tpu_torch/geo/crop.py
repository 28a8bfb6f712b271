"""Open-bbox 2D crops of point arrays. Counterpart of
``tomosar2height_tpu/geo/crop.py`` (``crop_pc_2d``, ``GridIndex2D``): strict
inequalities, so normalized points land inside the open unit square.

With ``native`` (the default) the float64 crops run in the C++ host runtime
(``native.crop_pc_2d_index``, bit-equal); ``native=False`` takes numpy, the
plain version."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tomosar2height_tpu_torch import native as host_runtime


def _inside(p: np.ndarray, p_min, p_max) -> np.ndarray:
    return ((p[:, 0] > p_min[0]) & (p[:, 0] < p_max[0])
            & (p[:, 1] > p_min[1]) & (p[:, 1] < p_max[1]))


def crop_pc_2d_index(points: np.ndarray, p_min, p_max) -> np.ndarray:
    """Ascending indices of the points strictly inside the (x, y) bbox (numpy)."""
    return np.nonzero(_inside(np.asarray(points), p_min, p_max))[0]


def crop_pc_2d(points: np.ndarray, p_min, p_max,
               native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Points strictly inside the (x, y) bbox and their ascending indices;
    ``native`` takes float64 points (world clouds) to the C++ runtime, whose
    crop is defined on float64; other dtypes compare in numpy."""
    p = np.asarray(points)
    if native and p.dtype == np.float64:
        idx = host_runtime.crop_pc_2d_index(p, p_min, p_max)
    else:
        idx = crop_pc_2d_index(p, p_min, p_max)
    return p[idx], idx


class GridIndex2D:
    """Uniform-grid index for repeated bbox crops of one cloud: one argsort at
    build, then each query touches only the grid cells under the box and
    returns exactly what ``crop_pc_2d`` would (its exact filter of the
    candidates in the C++ runtime where ``native``)."""

    def __init__(self, points: np.ndarray, cell_size: float, native: bool = True):
        self.native = bool(native)
        xy = np.asarray(points)[:, :2]
        self.cell = float(cell_size)
        self.x0 = float(xy[:, 0].min()) if len(xy) else 0.0
        self.y0 = float(xy[:, 1].min()) if len(xy) else 0.0
        if len(xy) == 0:
            self.nx = self.ny = 1
            self.order = np.zeros(0, np.int64)
            self.starts = np.zeros(2, np.int64)
            return
        ix = np.floor((xy[:, 0] - self.x0) / self.cell).astype(np.int64)
        iy = np.floor((xy[:, 1] - self.y0) / self.cell).astype(np.int64)
        self.nx = int(ix.max()) + 1
        self.ny = int(iy.max()) + 1
        code = ix * self.ny + iy
        self.order = np.argsort(code, kind="stable")
        counts = np.bincount(code, minlength=self.nx * self.ny)
        self.starts = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)

    def query_index(self, p_min, p_max) -> np.ndarray:
        """Ascending indices of the points in the grid cells under the bbox
        (a superset of the points inside it)."""
        ix0 = max(0, int(np.floor((p_min[0] - self.x0) / self.cell)))
        ix1 = min(self.nx - 1, int(np.floor((p_max[0] - self.x0) / self.cell)))
        iy0 = max(0, int(np.floor((p_min[1] - self.y0) / self.cell)))
        iy1 = min(self.ny - 1, int(np.floor((p_max[1] - self.y0) / self.cell)))
        if ix1 < ix0 or iy1 < iy0:
            return np.zeros(0, np.int64)
        cand = np.concatenate([
            self.order[self.starts[ix * self.ny + iy0]:self.starts[ix * self.ny + iy1 + 1]]
            for ix in range(ix0, ix1 + 1)])
        cand.sort()
        return cand

    def query(self, points: np.ndarray, p_min, p_max):
        """(cropped points, indices), as ``crop_pc_2d`` on the indexed cloud."""
        cand = self.query_index(p_min, p_max)
        p, keep = crop_pc_2d(np.asarray(points)[cand], p_min, p_max, native=self.native)
        return p, cand[keep]
