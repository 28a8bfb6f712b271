"""Local pooling (reduce + gather-back) and the encoder's plane scatter on the
Morton-aligned layout.

Counterpart of ``tomosar2height_tpu/ops/pallas/pool2_kernel.py``. Three CUDA
kernels (``csrc/pool2.cu``) replace its three Pallas kernels:

- K1 :func:`pool_reduce` <- ``_reduce_kernel`` (pool2_kernel.py:46): per-cell
  max, mean or sum of point features; an empty cell gives 0.
- K2 :func:`pool_gather` <- ``_gather_kernel`` (pool2_kernel.py:133): each
  point reads its cell's value back; pad rows give 0.
- K3 :func:`scatter_plane2` <- ``_scatter_plane_kernel`` (pool2_kernel.py:263):
  masked scatter-mean into a row-major NHWC plane, plus per-cell counts.

They read only the finest Morton cell ids and the mask: the TPU's chunk
metadata (ct/pt/tmask) served its sequential grid and has no use here. What
bounds them on the H100 and how the design answers it is noted in the CUDA
source. A CPU tensor takes the plain torch version (``*_plain``), a CUDA
tensor the kernel; there is no fallback between the two.

:func:`pool2` and :func:`scatter_plane2` are differentiable in ``values``
(``torch.autograd.Function``s); their backwards run on K1 and K2 as the JAX
custom_vjps do (pool2_kernel.py:424-453, :492-517):

- mean pool: one more masked mean pool of the cotangent;
- max pool: ``cell_sum = pool2(g, 'sum')``, then ``dv = where(values == out,
  cell_sum, 0)``: every tied point gets the whole cell sum;
- scatter_plane2: ``dv[i] = g_plane[cell_i] / max(count, 1)`` on valid rows,
  one K2 launch reading the row-major plane.
"""

from __future__ import annotations

import math

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.scatter import (
    segment_counts,
    segment_max,
    segment_mean,
    segment_sum,
)
from tomosar2height_tpu_torch.ops.sorted_scatter import morton_to_plane, plane_to_morton

_KINDS = {"max": 0, "mean": 1, "sum": 2}


def _valid_index(cells: torch.Tensor, mask: torch.Tensor, ncell: int):
    valid = mask & (cells >= 0) & (cells < ncell)
    return torch.where(valid, cells, torch.zeros_like(cells)), valid


# --- plain versions ---------------------------------------------------------------


def pool_reduce_plain(values, cells, mask, ncell: int, kind: str) -> torch.Tensor:
    """(B, N, F) values -> (B, ncell, F) per-cell max/mean/sum in Morton order."""
    idx, valid = _valid_index(cells, mask, ncell)
    if kind == "max":
        return segment_max(values, idx, ncell, valid)
    if kind == "sum":
        return segment_sum(values, idx, ncell, valid)
    return segment_mean(values, idx, ncell, valid)


def pool_gather_plain(cellv, cells, mask) -> torch.Tensor:
    """(B, ncell, F) cell values -> (B, N, F) per point; 0 where no cell."""
    idx, valid = _valid_index(cells, mask, cellv.shape[1])
    c = cellv.shape[-1]
    out = torch.gather(cellv, 1, idx.long()[..., None].expand(*idx.shape, c))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def pool2_plain(values, cells, mask, reso: int, kind: str) -> torch.Tensor:
    """Masked pool_local (reference pointnet.py:92-99): reduce then gather."""
    return pool_gather_plain(
        pool_reduce_plain(values, cells, mask, reso * reso, kind), cells, mask)


def scatter_plane2_plain(values, cells, mask, reso: int):
    """Masked scatter-mean -> (plane (B, reso, reso, F), counts (B, reso, reso)
    int32)."""
    ncell = reso * reso
    idx, valid = _valid_index(cells, mask, ncell)
    counts = segment_counts(idx, ncell, valid)
    vec = segment_mean(values, idx, ncell, valid, counts=counts)
    plane = morton_to_plane(vec, reso)
    return plane, morton_to_plane(counts, reso)[..., 0].to(torch.int32)


def pool2_bwd_plain(g, values, out, cells, mask, reso: int, kind: str) -> torch.Tensor:
    """Cotangent of :func:`pool2` w.r.t. ``values``, written out: mean ->
    masked mean pool of g; max -> the cell sum of g on every point tied with
    its cell's max."""
    if kind == "mean":
        return pool2_plain(g, cells, mask, reso, "mean")
    cell_sum = pool2_plain(g, cells, mask, reso, "sum")
    return torch.where(values == out, cell_sum, torch.zeros_like(cell_sum))


def scatter_plane2_bwd_plain(g_plane, cells, mask, counts) -> torch.Tensor:
    """Cotangent of :func:`scatter_plane2` w.r.t. ``values``: each valid row
    reads g_plane at its cell divided by max(count, 1); 0 elsewhere."""
    scaled = g_plane / counts.clamp_min(1).to(g_plane.dtype)[..., None]
    return pool_gather_plain(plane_to_morton(scaled), cells, mask)


# --- kernels ----------------------------------------------------------------------


def _check_points(values, cells, mask):
    dev = values.device
    b, n, f = values.shape
    runtime.require(values, "values", torch.float32, (b, n, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    return b, n, f


def pool_reduce(values, cells, mask, ncell: int, kind: str) -> torch.Tensor:
    """K1: per-cell ``kind`` ('max' | 'mean' | 'sum') reduce -> (B, ncell, F),
    Morton order; empty cells 0."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    if runtime.on_cpu(values):
        return pool_reduce_plain(values, cells, mask, ncell, kind)
    b, n, f = _check_points(values, cells, mask)
    lib = runtime.library()
    cellv = torch.empty((b, ncell, f), device=values.device, dtype=torch.float32)
    counts = torch.empty((b, ncell), device=values.device, dtype=torch.int32)
    err = lib.t2h_pool_reduce(values.data_ptr(), cells.data_ptr(), mask.data_ptr(),
                              cellv.data_ptr(), counts.data_ptr(), b, n, f, ncell,
                              _KINDS[kind], runtime.stream_ptr(values.device))
    runtime.check(err, "pool_reduce")
    runtime.LAUNCHES["pool_reduce"] += 1
    return cellv


def _gather(cellv, cells, mask, counts, reso: int) -> torch.Tensor:
    """Launch K2 on (B, ncell, F) Morton cell values (reso 0) or a row-major
    (B, reso, reso, F) plane with its (B, reso, reso) counts (reso > 0)."""
    dev = cellv.device
    b, f = cellv.shape[0], cellv.shape[-1]
    ncell = math.prod(cellv.shape[1:-1])
    n = cells.shape[-1]
    runtime.require(cellv, "cellv", torch.float32, tuple(cellv.shape), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    if counts is not None:
        runtime.require(counts, "counts", torch.int32, tuple(cellv.shape[:-1]), dev)
    lib = runtime.library()
    out = torch.empty((b, n, f), device=dev, dtype=torch.float32)
    err = lib.t2h_pool_gather(cellv.data_ptr(), cells.data_ptr(), mask.data_ptr(),
                              0 if counts is None else counts.data_ptr(),
                              out.data_ptr(), b, n, f, ncell, reso,
                              runtime.stream_ptr(dev))
    runtime.check(err, "pool_gather")
    runtime.LAUNCHES["pool_gather"] += 1
    return out


def pool_gather(cellv, cells, mask) -> torch.Tensor:
    """K2: per-point gather-back of (B, ncell, F) cell values -> (B, N, F);
    0 on pad rows."""
    if runtime.on_cpu(cellv):
        return pool_gather_plain(cellv, cells, mask)
    if cellv.dim() != 3:
        raise ValueError(f"cellv: shape {tuple(cellv.shape)}, expected (B, ncell, F)")
    return _gather(cellv, cells, mask, None, 0)


def _pool2(values, cells, mask, reso: int, kind: str) -> torch.Tensor:
    return pool_gather(pool_reduce(values, cells, mask, reso * reso, kind),
                       cells, mask)


def pool2_bwd(g, values, out, cells, mask, reso: int, kind: str) -> torch.Tensor:
    """Backward of :func:`pool2`: K1 ('mean', or 'sum' for max pooling) then
    K2; the max-pool tie gate is one elementwise select. Counted once per
    call in ``LAUNCHES['pool2_bwd']`` besides K1's and K2's own counts."""
    if runtime.on_cpu(g):
        return pool2_bwd_plain(g, values, out, cells, mask, reso, kind)
    runtime.LAUNCHES["pool2_bwd"] += 1
    if kind == "mean":
        return _pool2(g, cells, mask, reso, "mean")
    cell_sum = _pool2(g, cells, mask, reso, "sum")
    return torch.where(values == out, cell_sum, torch.zeros_like(cell_sum))


def scatter_plane2_bwd(g_plane, cells, mask, counts) -> torch.Tensor:
    """Backward of :func:`scatter_plane2`: K2 reading the row-major cotangent
    plane at each valid row's cell, divided by max(count, 1). Counted in
    ``LAUNCHES['scatter_plane2_bwd']`` besides K2's own count."""
    if runtime.on_cpu(g_plane):
        return scatter_plane2_bwd_plain(g_plane, cells, mask, counts)
    runtime.LAUNCHES["scatter_plane2_bwd"] += 1
    return _gather(g_plane, cells, mask, counts, g_plane.shape[1])


class _Pool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, cells, mask, reso: int, kind: str):
        out = _pool2(values, cells, mask, reso, kind)
        ctx.save_for_backward(values, cells, mask, out)
        ctx.reso, ctx.kind = reso, kind
        return out

    @staticmethod
    def backward(ctx, g):
        values, cells, mask, out = ctx.saved_tensors
        dv = pool2_bwd(g.contiguous(), values, out, cells, mask, ctx.reso, ctx.kind)
        return dv, None, None, None, None


class _ScatterPlane2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, cells, mask, reso: int):
        plane, counts = _scatter_plane2(values, cells, mask, reso)
        ctx.mark_non_differentiable(counts)
        ctx.save_for_backward(cells, mask, counts)
        return plane, counts

    @staticmethod
    def backward(ctx, g_plane, _g_counts):
        cells, mask, counts = ctx.saved_tensors
        return scatter_plane2_bwd(g_plane.contiguous(), cells, mask, counts), None, None, None


def pool2(values, cells, mask, reso: int, kind: str) -> torch.Tensor:
    """Masked pool_local on the aligned layout: K1 then K2; differentiable in
    ``values`` (backward: :func:`pool2_bwd`).

    Args:
        values: (B, N, F) f32 point features.
        cells: (B, N) int32 finest Morton ids (PAD_CELL_SENTINEL on pads).
        mask: (B, N) bool validity.
        reso: plane resolution of ``cells``.
        kind: 'max' | 'mean'.
    """
    if kind not in ("max", "mean"):
        raise ValueError(f"pool2 kind must be 'max' or 'mean', got {kind!r}")
    return _Pool2.apply(values, cells, mask, reso, kind)


def scatter_plane2(values, cells, mask, reso: int):
    """K3: masked scatter-mean into a row-major NHWC plane (the encoder's plane
    emission, reference pointnet.py:101-111). Returns (plane (B, reso, reso, F),
    counts (B, reso, reso) int32); empty cells 0. Differentiable in
    ``values`` (backward: :func:`scatter_plane2_bwd`)."""
    return _ScatterPlane2.apply(values, cells, mask, reso)


def _scatter_plane2(values, cells, mask, reso: int):
    if runtime.on_cpu(values):
        return scatter_plane2_plain(values, cells, mask, reso)
    b, n, f = _check_points(values, cells, mask)
    lib = runtime.library()
    plane = torch.empty((b, reso, reso, f), device=values.device, dtype=torch.float32)
    counts = torch.empty((b, reso, reso), device=values.device, dtype=torch.int32)
    err = lib.t2h_scatter_plane(values.data_ptr(), cells.data_ptr(), mask.data_ptr(),
                                plane.data_ptr(), counts.data_ptr(), b, n, f, reso,
                                runtime.stream_ptr(values.device))
    runtime.check(err, "scatter_plane2")
    runtime.LAUNCHES["scatter_plane2"] += 1
    return plane, counts
