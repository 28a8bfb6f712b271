"""Morton-sorted point layouts: the host half (numpy) plus the device-side
cell-id recompute and the Morton -> row-major plane permutation (torch).

Counterpart of ``tomosar2height_tpu/ops/sorted_scatter.py``. The host
functions are copies of the JAX module's (that module imports JAX at its top),
so a batch built here is bit-identical to one built there: same Morton ids,
same ``PCHUNK``-aligned 1024-cell tiles, same pad rows.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_CELL_SENTINEL = np.int32(1 << 30)
"""Cell id of padding rows in the aligned layout: ``sentinel >> 2*level`` is
never a valid cell at any pyramid level (level <= 6)."""

ALIGNED_TILE_CELLS = 1024
"""Cells per Morton tile of the chunk-aligned layout (32x32 spatial)."""

PCHUNK = 128
"""Row quantum of the aligned layout: every tile's point run is padded to a
multiple of it (the TPU kernels' point chunk; kept for a bit-identical
layout)."""


# --- host side -------------------------------------------------------------------


def morton_interleave_np(x: np.ndarray, y: np.ndarray, bits: int) -> np.ndarray:
    """Interleave bits of (x, y) -> z-order code (y high bits), vectorized numpy."""
    code = np.zeros_like(x, dtype=np.int64)
    for b in range(bits):
        code |= ((x >> b) & 1) << (2 * b)
        code |= ((y >> b) & 1) << (2 * b + 1)
    return code


def host_morton_bucket(points: np.ndarray, mask: np.ndarray, reso: int):
    """Sort padded points by Morton cell id; padded points sort to the end.

    Returns order (N,) int64, sorted cell ids (N,) int32 (pads get
    ``reso*reso``) and segment offsets (reso*reso + 1,) int32.
    """
    bits = int(reso).bit_length() - 1
    assert (1 << bits) == reso, "plane resolution must be a power of two"
    xi = np.clip((points[:, 0] * reso).astype(np.int64), 0, reso - 1)
    yi = np.clip((points[:, 1] * reso).astype(np.int64), 0, reso - 1)
    code = morton_interleave_np(xi, yi, bits)
    ncell = reso * reso
    code = np.where(mask, code, ncell)  # padding sorts last
    order = np.argsort(code, kind="stable")
    code_sorted = code[order]
    offsets = np.searchsorted(code_sorted, np.arange(ncell + 1)).astype(np.int32)
    return order, code_sorted.astype(np.int32), offsets


def aligned_bucket_size(bucket: int, reso: int, chunk: int = PCHUNK,
                        tile_cells: int = ALIGNED_TILE_CELLS) -> int:
    """Static point-array length of the chunk-aligned Morton layout."""
    ntiles = (reso * reso) // tile_cells
    return ((bucket + chunk - 1) // chunk) * chunk + ntiles * chunk


def host_morton_bucket_aligned(points: np.ndarray, mask: np.ndarray, reso: int,
                               chunk: int = PCHUNK,
                               tile_cells: int = ALIGNED_TILE_CELLS):
    """Morton-sort points and pad every tile's point run to a ``chunk`` multiple.

    Returns a dict of points (Npad, 3) f32 (pad rows 0.5), mask (Npad,) bool,
    cells (Npad,) int32 (``PAD_CELL_SENTINEL`` on pads) and tile_offsets
    (ntiles + 1,) int32, with Npad == aligned_bucket_size(len(points), ...).
    """
    n = points.shape[0]
    ntiles = (reso * reso) // tile_cells
    npad = aligned_bucket_size(n, reso, chunk, tile_cells)
    order, code_sorted, offsets = host_morton_bucket(points, mask, reso)

    tile_off = offsets[::tile_cells].astype(np.int64)  # (ntiles + 1,)
    counts = np.diff(tile_off)
    padded = ((counts + chunk - 1) // chunk) * chunk
    astarts = np.zeros(ntiles + 1, dtype=np.int64)
    np.cumsum(padded, out=astarts[1:])
    assert astarts[-1] <= npad

    # dst[i] = aligned position of sorted point i (vectorized per-tile shift)
    src_valid = int(tile_off[-1])
    tile_of_sorted = np.searchsorted(tile_off, np.arange(src_valid), side="right") - 1
    dst = np.arange(src_valid) + (astarts[:-1] - tile_off[:-1])[tile_of_sorted]

    out_pts = np.full((npad, 3), 0.5, dtype=np.float32)
    out_mask = np.zeros((npad,), dtype=bool)
    out_cells = np.full((npad,), PAD_CELL_SENTINEL, dtype=np.int32)
    out_pts[dst] = points[order[:src_valid]]
    out_mask[dst] = True
    out_cells[dst] = code_sorted[:src_valid]
    return {
        "points": out_pts,
        "mask": out_mask,
        "cells": out_cells,
        "tile_offsets": astarts.astype(np.int32),
    }


def trim_aligned_batch(points, mask, cells, tile_offsets, quantum: int = 4096):
    """Trim a batch of aligned layouts to the smallest ``quantum``-multiple row
    count covering every entry's used rows (``tile_offsets[:, -1]``)."""
    used = int(np.max(tile_offsets[:, -1])) if len(tile_offsets) else 0
    npad = max(((used + quantum - 1) // quantum) * quantum, quantum)
    npad = min(npad, points.shape[1])
    return points[:, :npad], mask[:, :npad], cells[:, :npad], tile_offsets


# --- device side ----------------------------------------------------------------


def morton_cells_device(points: torch.Tensor, mask: torch.Tensor, reso: int,
                        pad_value: int) -> torch.Tensor:
    """Recompute the layout's per-row Morton cell ids from points and mask.

    Bit-exact with the host layouts (same f32 multiply, truncation and clip as
    :func:`host_morton_bucket`). ``pad_value`` is PAD_CELL_SENTINEL for the
    aligned layout, ``reso*reso`` for the plain sorted one. Returns int32.
    """
    bits = int(reso).bit_length() - 1
    assert (1 << bits) == reso, "plane resolution must be a power of two"
    xy = points.to(torch.float32)
    xi = (xy[..., 0] * reso).to(torch.int32).clamp(0, reso - 1)
    yi = (xy[..., 1] * reso).to(torch.int32).clamp(0, reso - 1)
    code = torch.zeros_like(xi)
    for b in range(bits):
        code = code | (((xi >> b) & 1) << (2 * b))
        code = code | (((yi >> b) & 1) << (2 * b + 1))
    return torch.where(mask, code, torch.full_like(code, int(pad_value)))


def morton_to_plane(vec: torch.Tensor, reso: int) -> torch.Tensor:
    """(B, reso*reso, C) Morton-ordered -> (B, reso, reso, C) row-major."""
    b, _, c = vec.shape
    bits = int(reso).bit_length() - 1
    x = vec.reshape((b,) + (2,) * (2 * bits) + (c,))
    # Morton dims after the reshape: (y_{b-1}, x_{b-1}, ..., y_0, x_0)
    ys = tuple(1 + 2 * i for i in range(bits))
    xs = tuple(2 + 2 * i for i in range(bits))
    perm = (0,) + ys + xs + (2 * bits + 1,)
    return x.permute(perm).reshape(b, reso, reso, c)


def plane_to_morton(plane: torch.Tensor) -> torch.Tensor:
    """(B, reso, reso, C) row-major -> (B, reso*reso, C) Morton-ordered; the
    inverse of :func:`morton_to_plane`."""
    b, reso, _, c = plane.shape
    bits = int(reso).bit_length() - 1
    x = plane.reshape((b,) + (2,) * (2 * bits) + (c,))
    # row-major dims after the reshape: (y_{b-1}, ..., y_0, x_{b-1}, ..., x_0)
    perm = (0,) + tuple(d for i in range(bits) for d in (1 + i, 1 + bits + i)) \
        + (2 * bits + 1,)
    return x.permute(perm).reshape(b, reso * reso, c)
