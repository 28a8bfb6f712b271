"""Morton-sorted point layouts: the host half (numpy) plus the device side
(torch): the cell-id recompute, the Morton <-> row-major plane permutations
and the segmented reductions over cell-sorted rows.

Counterpart of ``tomosar2height_tpu/ops/sorted_scatter.py``. The host
functions are copies of the JAX module's (that module imports JAX at its top),
so a batch built here is bit-identical to one built there: same Morton ids,
same ``PCHUNK``-aligned tiles, same pad rows.

On the device, a segment reduction over sorted rows is a cumulative sum, two
gathers and a difference (:func:`sorted_segment_mean`, the ``cumsum`` path),
and its backward, as that of the gather-back (:func:`gather_sorted_rows`),
runs in a fixed order: no scatter adds with atomics;
coarser resolutions reuse the finest sort, since a Morton parent covers a
contiguous run of children (:func:`coarsen_offsets`). ``impl='pallas'``
routes the per-cell means through the tile kernels K11/K13
(``ops/cuda/scatter_kernel.py``) where the plane holds whole 256-cell tiles.
"""

from __future__ import annotations

import numpy as np
import torch

POINT_WIRE_SCALE = 65535.0
"""u16 point wire: coordinates in [0, 1] ship as uint16 (6 bytes a point
instead of 12), ~7.8 mm xy / ~3 mm z at the flagship's patch extents. The
dequantization is one f32 multiply by ``float32(1 / 65535)``, the same on the
host and on the card, so cell ids recomputed on the card equal the host
layout's (the JAX package's ``ops/sorted_scatter.py:73-97``)."""

_DEQ16 = np.float32(1.0 / POINT_WIRE_SCALE)


def quantize_points_u16(points: np.ndarray) -> np.ndarray:
    """f32 [0, 1] coordinates -> the uint16 wire."""
    return np.clip(np.round(points * POINT_WIRE_SCALE), 0.0,
                   POINT_WIRE_SCALE).astype(np.uint16)


def dequantize_points_np(q: np.ndarray) -> np.ndarray:
    """uint16 wire points -> f32, bit-equal to :func:`dequantize_points`."""
    return q.astype(np.float32) * _DEQ16


def dequantize_points(q: torch.Tensor) -> torch.Tensor:
    """uint16 wire points -> f32 on their device: the host's multiply."""
    return q.to(torch.float32) * float(_DEQ16)


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


def coarsen_tile_offsets(tile_offsets: torch.Tensor, levels: int) -> torch.Tensor:
    """Tile offsets of a 2**levels coarser plane: every 4**levels-th (a coarse
    tile is the union of 4**levels consecutive fine Morton tiles)."""
    return tile_offsets[..., :: 4 ** levels]


def coarsen_offsets(offsets: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-cell offsets of a 2**levels coarser resolution: every 4**levels-th
    (Morton parents cover contiguous runs of children)."""
    return offsets[..., :: 4 ** levels]


def _segment_sums(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(B, S, C) sums of the row ranges [offsets[s], offsets[s + 1]) of
    (B, N, C) values: differences of a float64 running sum, in the values'
    dtype. A fixed order: bit-equal run to run."""
    b, _, c = values.shape
    csum = torch.cumsum(values, dim=1, dtype=torch.float64)
    csum = torch.cat([csum.new_zeros(b, 1, c), csum], dim=1)  # (B, N + 1, C)
    starts, ends = offsets[:, :-1].long(), offsets[:, 1:].long()

    def take(idx):
        return torch.gather(csum, 1, idx[..., None].expand(*idx.shape, c))

    return (take(ends) - take(starts)).to(values.dtype)


def _row_segments(offsets: torch.Tensor, n: int):
    """(segment id, in a segment) of each of n rows under (B, S + 1) offsets."""
    rows = torch.arange(n, device=offsets.device, dtype=offsets.dtype)
    rows = rows.expand(offsets.shape[0], n).contiguous()
    seg = torch.searchsorted(offsets.contiguous(), rows, right=True) - 1
    inside = (rows >= offsets[:, :1]) & (rows < offsets[:, -1:])
    return seg.clamp(0, offsets.shape[1] - 2).long(), inside


class _SortedSegmentSum(torch.autograd.Function):
    """:func:`_segment_sums`, whose backward hands each row in a segment its
    segment's cotangent (a gather: no scatter, no atomics), so training on
    the cumsum path is bit-equal run to run."""

    @staticmethod
    def forward(ctx, values, offsets):
        ctx.save_for_backward(offsets)
        ctx.n = values.shape[1]
        return _segment_sums(values, offsets)

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        seg, inside = _row_segments(offsets, ctx.n)
        dv = torch.gather(g, 1, seg[..., None].expand(*seg.shape, g.shape[-1]))
        return torch.where(inside[..., None], dv, torch.zeros_like(dv)), None


class _SortedGather(torch.autograd.Function):
    """Per-row gather-back of cell values on the plain sorted layout, whose
    backward sums each cell's rows (the rows past the last offset, the pads,
    clip to the last cell, as the forward reads them) with
    :func:`_segment_sums`: a fixed order, bit-equal run to run."""

    @staticmethod
    def forward(ctx, cell_values, cells, offsets):
        ctx.save_for_backward(offsets)
        ctx.n = cells.shape[1]
        return gather_cells_sorted(cell_values, cells)

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        ends = offsets.clone()
        ends[:, -1] = ctx.n  # the pads read the last cell
        return _segment_sums(g, ends), None, None


def sorted_segment_sum_counts(values: torch.Tensor, offsets: torch.Tensor):
    """Per-segment (sums (B, S, C), counts (B, S, 1)) of cell-sorted (B, N, C)
    values with (B, S + 1) segment offsets; rows past ``offsets[:, -1]`` (the
    pads) are in no segment.

    The JAX package sums in float32; the port's cumulative sum runs in
    float64, so a segment's sum does not inherit the rounding of a large
    running total (a float32 total of 1e4 rounds in steps of ~1e-3). Its
    backward gathers each row's segment cotangent (:class:`_SortedSegmentSum`).
    bf16 values: each sum rounded to bf16 once, the counts cast to bf16 (the
    nearest bf16 above 256 rows), as JAX's ops/sorted_scatter.py:301-315."""
    sums = _SortedSegmentSum.apply(values, offsets)
    counts = (offsets[:, 1:] - offsets[:, :-1]).long()[..., None].to(values.dtype)
    return sums, counts


def sorted_segment_mean(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-cell mean over cell-sorted rows; empty cells are 0. bf16: the
    bf16 sum over the bf16 count, divided in bf16 (JAX's rounding points)."""
    sums, counts = sorted_segment_sum_counts(values, offsets)
    return sums / counts.clamp_min(1.0)


def gather_cells_sorted(cell_values: torch.Tensor, cell_ids: torch.Tensor) -> torch.Tensor:
    """Per-row gather-back of (B, S, C) cell values at (B, N) ids; ids past
    the last cell (the plain sorted layout's pads, ``S``) are clipped, and
    their rows must be masked downstream."""
    s, c = cell_values.shape[1], cell_values.shape[-1]
    idx = cell_ids.long().clamp_max(s - 1)
    return torch.gather(cell_values, 1, idx[..., None].expand(*idx.shape, c))


def gather_sorted_rows(cell_values: torch.Tensor, cells: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """:func:`gather_cells_sorted` on the plain sorted layout (``offsets``
    its per-cell offsets), differentiable in ``cell_values`` with a
    fixed-order backward (:class:`_SortedGather`)."""
    return _SortedGather.apply(cell_values, cells, offsets)


def scatter_mean_morton(values: torch.Tensor, offsets: torch.Tensor, cells: torch.Tensor,
                        reso: int, impl: str = "cumsum") -> torch.Tensor:
    """Morton-ordered per-cell mean (B, reso**2, C) of cell-sorted rows:
    K13 under ``impl='pallas'`` where reso**2 holds whole 256-cell tiles,
    else the cumsum path."""
    if impl == "pallas" and (reso * reso) % 256 == 0:
        from tomosar2height_tpu_torch.ops.cuda.scatter_kernel import scatter_mean

        return scatter_mean(values.contiguous(), cells.contiguous(), offsets.contiguous(),
                            reso)
    return sorted_segment_mean(values, offsets)


def scatter_mean_plane_morton(values: torch.Tensor, offsets: torch.Tensor,
                              cells: torch.Tensor, reso: int,
                              impl: str = "cumsum") -> torch.Tensor:
    """Cell-sorted rows -> row-major NHWC plane (B, reso, reso, C): K11 under
    ``impl='pallas'`` where reso**2 holds whole 256-cell tiles, else
    :func:`sorted_segment_mean` + :func:`morton_to_plane`."""
    if impl == "pallas" and (reso * reso) % 256 == 0:
        from tomosar2height_tpu_torch.ops.cuda.scatter_kernel import scatter_mean_plane

        return scatter_mean_plane(values.contiguous(), cells.contiguous(),
                                  offsets.contiguous(), reso)
    return morton_to_plane(sorted_segment_mean(values, offsets), reso)
