"""ctypes bindings of the port's C++ host runtime (``csrc/host_runtime.cpp``).

The library is built with ``g++`` at first use into
``tomosar2height_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source, the flags and ``g++ --version``; it is compiled to a
name of its own (the process id in it) and renamed into place, so processes
that build at once each load a whole library. A failed build raises with the
compiler's log: nothing here falls back to numpy. The numpy plain versions of
the entry points are :mod:`tomosar2height_tpu_torch.native.plain`; the
loader and the generator reach them only through their ``native=False``
argument.

A ctypes call releases the GIL, so the loader's worker threads and the
serving loop's blend run beside each other. Each wrapper adds one to its
entry of :data:`CALLS`, so a run can show which entry points its path went
through. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_runtime.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-ffp-contract=off")
"""No ``-ffast-math`` and no FMA contraction: each entry point is bit-equal
to its numpy plain version."""

CALLS = {k: 0 for k in ("crop_pc_2d", "transform_points_f32", "crop_transform_patch",
                        "las_read", "bucket_points", "max_z_grid", "blend_accumulate",
                        "blend_accumulate_batch", "morton_align")}
"""Calls of each C++ entry point since the last :func:`reset_calls`."""

BUILD_INFO: dict = {}
"""Of the library this process loaded: path, whether it was built now, build
seconds."""

LAS_ERRORS = {-1: "the file does not open", -2: "not a LAS file (magic, header or record "
              "length)", -3: "LAZ (compressed) point formats are not supported",
              -4: "the point records are truncated", -5: "unsupported LAS version"}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_D = ctypes.c_double
_F = ctypes.c_float

_SIGNATURES = {
    "t2h_crop_pc_2d": (_I64, [_P, _I64, _I64, _D, _D, _D, _D, _P]),
    "t2h_transform_points_f32": (None, [_P, _I64, _P, _P]),
    "t2h_crop_transform_patch": (_I64, [_P, _I64, _D, _D, _D, _D, _P, _F, _F, _F, _F, _P]),
    "t2h_las_read": (_I64, [ctypes.c_char_p, _P]),
    "t2h_bucket_points": (None, [_P, _I64, _I64, _I32, _P, _P]),
    "t2h_max_z_grid": (None, [_P, _I64, _D, _D, _D, _D, _D, _D, _P, _I64, _I64]),
    "t2h_blend_accumulate": (None, [_P, _P, _I64, _I64, _P, _P, _I64, _I64, _I64, _I64]),
    "t2h_blend_accumulate_batch": (None, [_P, _P, _I64, _I64, _P, _P, _I64, _I64, _I64,
                                          _P, _P, _P, _I64]),
    "t2h_morton_align": (_I64, [_P, _P, _I64, _I32, _I32, _I32, _I64, _I32, _P, _P, _P, _P]),
    "t2h_host_runtime_version": (ctypes.c_char_p, []),
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def compiler() -> str:
    """``g++`` on ``PATH``; raises where there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime is built with g++")
    return cxx


def library_path(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """The library's path: a hash of the source, the flags and the compiler's
    version names it."""
    version = subprocess.run([compiler(), "--version"], capture_output=True, text=True,
                             check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + version.encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"libt2h_host_{h.hexdigest()[:16]}.so")


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> tuple:
    """Build the library from ``source`` into ``build_dir`` unless it is
    there. Returns (path, built now, seconds). The compiler writes to a name
    of its own, renamed into place once whole; raises with the compiler's log
    if it fails."""
    so_path = library_path(source, build_dir)
    if os.path.exists(so_path):
        return so_path, False, 0.0
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    out = subprocess.run([compiler(), *CXX_FLAGS, "-o", tmp, source],
                         capture_output=True, text=True)
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({out.returncode}) building {source}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so_path)
    return so_path, True, time.perf_counter() - t0


def load(path: str) -> ctypes.CDLL:
    """Load a built library and declare its entry points."""
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def library() -> ctypes.CDLL:
    """The host runtime: built if missing, then loaded (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            path, built, seconds = build()
            _lib = load(path)
            BUILD_INFO.update(path=path, built=built, seconds=seconds)
        return _lib


def reset_calls() -> None:
    """Set every call count to 0."""
    for k in CALLS:
        CALLS[k] = 0


def _call(name: str):
    lib = library()
    with _count_lock:
        CALLS[name] += 1
    return getattr(lib, f"t2h_{name}")


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _matrix(m4) -> np.ndarray:
    m = _f64(m4)
    if m.shape != (4, 4):
        raise ValueError(f"expected a 4x4 transform, got {m.shape}")
    return m


def _points3(points, dtype) -> np.ndarray:
    p = np.ascontiguousarray(points, dtype=dtype)
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"expected (n, 3) points, got {p.shape}")
    return p


def crop_pc_2d_index(points: np.ndarray, p_min, p_max) -> np.ndarray:
    """Ascending indices of the points strictly inside the (x, y) bbox;
    ``points`` (n, >= 2) float64."""
    p = np.asarray(points)
    if p.dtype != np.float64 or p.ndim != 2 or p.shape[1] < 2:
        raise TypeError(f"crop_pc_2d_index takes (n, >= 2) float64 points, got "
                        f"{p.dtype} {p.shape}")
    p = np.ascontiguousarray(p)
    out = np.empty(p.shape[0], dtype=np.int64)
    k = _call("crop_pc_2d")(p.ctypes.data, p.shape[0], p.shape[1], float(p_min[0]),
                            float(p_min[1]), float(p_max[0]), float(p_max[1]),
                            out.ctypes.data)
    return out[:k].copy()


def transform_points_f32(points: np.ndarray, m4: np.ndarray) -> np.ndarray:
    """(n, 3) points through the 4x4 ``m4`` in float64, cast to float32."""
    p, m = _points3(points, np.float64), _matrix(m4)
    out = np.empty((p.shape[0], 3), dtype=np.float32)
    _call("transform_points_f32")(p.ctypes.data, p.shape[0], m.ctypes.data, out.ctypes.data)
    return out


def crop_transform_patch(points: np.ndarray, p_min, p_max, m4: np.ndarray,
                         norm_min, norm_max) -> np.ndarray:
    """The patch normalize: the points strictly inside the world bbox
    (``p_min``, ``p_max``), through ``m4``, cast to float32 and kept strictly
    inside the normalized bbox (``norm_min``, ``norm_max``), compared in
    float32. Returns (m, 3) float32."""
    p, m = _points3(points, np.float64), _matrix(m4)
    out = np.empty((p.shape[0], 3), dtype=np.float32)
    lo = [float(np.float32(v)) for v in norm_min[:2]]
    hi = [float(np.float32(v)) for v in norm_max[:2]]
    k = _call("crop_transform_patch")(
        p.ctypes.data, p.shape[0], float(p_min[0]), float(p_min[1]), float(p_max[0]),
        float(p_max[1]), m.ctypes.data, lo[0], lo[1], hi[0], hi[1], out.ctypes.data)
    return out[:k]


def las_read(path: str) -> np.ndarray:
    """(n, 3) float64 world coordinates of a LAS 1.0-1.4 file; raises
    ValueError on a file it cannot read."""
    fn = _call("las_read")
    raw = os.fsencode(path)
    n = fn(raw, None)
    if n < 0:
        raise ValueError(f"{path}: {LAS_ERRORS.get(n, n)}")
    out = np.empty((n, 3), dtype=np.float64)
    n2 = fn(raw, out.ctypes.data)
    if n2 != n:
        raise ValueError(f"{path}: {LAS_ERRORS.get(n2, n2)}")
    return out


def bucket_points(points_xy: np.ndarray, reso: int):
    """(cells (n,) int32, order (n,) int64): the cell of each float32 point
    and the stable permutation that sorts them by cell."""
    p = _f32(points_xy)
    if p.ndim != 2 or p.shape[1] < 2:
        raise ValueError(f"expected (n, >= 2) points, got {p.shape}")
    cells = np.empty(p.shape[0], dtype=np.int32)
    order = np.empty(p.shape[0], dtype=np.int64)
    _call("bucket_points")(p.ctypes.data, p.shape[0], p.shape[1], int(reso),
                           cells.ctypes.data, order.ctypes.data)
    return cells, order


def max_z_grid(points: np.ndarray, bl, tr, pixel) -> np.ndarray:
    """The (rows, cols) float32 raster of the highest z a pixel holds
    (-inf where none), row 0 north."""
    p = _points3(points, np.float64)
    rows = int(np.floor((tr[1] - bl[1]) / pixel[1]))
    cols = int(np.floor((tr[0] - bl[0]) / pixel[0]))
    grid = np.full((rows, cols), -np.inf, dtype=np.float32)
    _call("max_z_grid")(p.ctypes.data, p.shape[0], float(bl[0]), float(bl[1]),
                        float(tr[0]), float(tr[1]), float(pixel[0]), float(pixel[1]),
                        grid.ctypes.data, rows, cols)
    return grid


def _scene(dsm: np.ndarray, weight: np.ndarray) -> None:
    for a in (dsm, weight):
        if a.dtype != np.float64 or not a.flags.c_contiguous or a.ndim != 2:
            raise TypeError("the scene rasters are C-contiguous 2-D float64 arrays")
    if dsm.shape != weight.shape:
        raise ValueError(f"scene rasters {dsm.shape} and {weight.shape} differ")


def blend_accumulate(dsm: np.ndarray, weight: np.ndarray, patch: np.ndarray,
                     w: np.ndarray, row0: int, col0: int) -> None:
    """dsm += patch * w and weight += w in place over the window at (row0,
    col0), clipped to the scene."""
    _scene(dsm, weight)
    p, ww = _f64(patch), _f64(w)
    if p.shape != ww.shape or p.ndim != 2:
        raise ValueError(f"patch {p.shape} and weight {ww.shape}")
    _call("blend_accumulate")(dsm.ctypes.data, weight.ctypes.data, dsm.shape[0],
                              dsm.shape[1], p.ctypes.data, ww.ctypes.data, p.shape[0],
                              p.shape[1], int(row0), int(col0))


def default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def blend_accumulate_batch(dsm: np.ndarray, weight: np.ndarray, patches: np.ndarray,
                           w: np.ndarray, rows0, cols0, valid, nthreads: int = 0) -> None:
    """:func:`blend_accumulate` of each valid tile of a (B, ph, pw) batch, in
    batch order, in one call: ``nthreads`` threads (0: the host's cores, at
    most 16) over disjoint row bands of the scene."""
    _scene(dsm, weight)
    p, ww = _f64(patches), _f64(w)
    if p.ndim != 3 or p.shape[1:] != ww.shape:
        raise ValueError(f"patches {p.shape} and weight {ww.shape}")
    b = p.shape[0]
    r0 = np.ascontiguousarray(rows0, dtype=np.int64).reshape(b)
    c0 = np.ascontiguousarray(cols0, dtype=np.int64).reshape(b)
    va = np.ascontiguousarray(valid, dtype=np.uint8).reshape(b)
    _call("blend_accumulate_batch")(
        dsm.ctypes.data, weight.ctypes.data, dsm.shape[0], dsm.shape[1], p.ctypes.data,
        ww.ctypes.data, b, p.shape[1], p.shape[2], r0.ctypes.data, c0.ctypes.data,
        va.ctypes.data, int(nthreads) if nthreads > 0 else default_threads())


def morton_align(points: np.ndarray, mask: Optional[np.ndarray], reso: int, chunk: int,
                 tile_cells: int, npad: int, pad_cell_sentinel: int, out=None) -> dict:
    """The chunk-aligned Morton layout of (n, 3) float32 points (``mask``
    None: every point valid) in ``npad`` rows: the dict of
    ``host_morton_bucket_aligned``. ``out`` = (points (npad, 3) f32, mask
    (npad,) bool, cells (npad,) int32, tile offsets (ntiles + 1,) int32),
    C-contiguous, receives it in place. Raises where the layout passes
    ``npad``."""
    if reso < 1 or reso & (reso - 1) or (reso * reso) % tile_cells or chunk < 1:
        raise ValueError(f"reso {reso} must be a power of two whose square the tile "
                         f"({tile_cells} cells) divides; chunk {chunk}")
    p = _points3(points, np.float32)
    m = None if mask is None else np.ascontiguousarray(mask, dtype=bool).view(np.uint8)
    if m is not None and m.shape != (p.shape[0],):
        raise ValueError(f"mask {m.shape} for {p.shape[0]} points")
    ntiles = (reso * reso) // tile_cells
    if out is None:
        out = (np.empty((npad, 3), dtype=np.float32), np.empty((npad,), dtype=bool),
               np.empty((npad,), dtype=np.int32), np.empty((ntiles + 1,), dtype=np.int32))
    o_pts, o_mask, o_cells, o_toff = out
    for a, dt, shape in ((o_pts, np.float32, (npad, 3)), (o_mask, np.bool_, (npad,)),
                         (o_cells, np.int32, (npad,)), (o_toff, np.int32, (ntiles + 1,))):
        if a.dtype != dt or a.shape != shape or not a.flags.c_contiguous:
            raise ValueError(f"out array {a.dtype} {a.shape}, expected {np.dtype(dt)} {shape}")
    used = _call("morton_align")(
        p.ctypes.data, None if m is None else m.ctypes.data, p.shape[0], int(reso),
        int(chunk), int(tile_cells), int(npad), int(pad_cell_sentinel), o_pts.ctypes.data,
        o_mask.ctypes.data, o_cells.ctypes.data, o_toff.ctypes.data)
    if used < 0:
        raise ValueError(f"the aligned layout of {p.shape[0]} points passes {npad} rows")
    return {"points": o_pts, "mask": o_mask, "cells": o_cells, "tile_offsets": o_toff}
