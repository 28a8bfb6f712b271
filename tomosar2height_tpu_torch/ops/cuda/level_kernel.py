"""One fused ALTO level round trip (sample -> MLP -> scatter) and its backward.

Counterpart of ``tomosar2height_tpu/ops/pallas/level_kernel.py``. The CUDA
kernel K4 (``csrc/level.cu``) replaces ``_level_kernel`` (level_kernel.py:110,
launched by ``_fused_level_impl``): bilinear-sample the plane at each point
(border clamp, align_corners=True), run ``fc_comm`` (Linear(F,2F) -> ReLU ->
Linear(2F,F)) plus the ``fc_c`` skip from the previous level's point
features, zero the padding rows, and scatter-mean the result into the plane at
this level's resolution (cell = finest Morton id >> 2*level).

The kernel reads only the points, cell ids and mask; the TPU's chunk
metadata, lane padding and empty-tile mask have no use here (empty cells
come out 0 by construction). What bounds it on the H100 and how the design
answers it is noted in the CUDA source. A CPU tensor takes
:func:`fused_level_plain` (the counterpart of ``_level_ref``,
level_kernel.py:494), a CUDA tensor the kernel; there is no fallback.

:func:`fused_level` is a ``torch.autograd.Function`` (the counterpart of the
JAX custom_vjp, level_kernel.py:605-664) differentiable in the plane, c_last
and the six weights. Its backward is K5 (``csrc/level_bwd.cu``, replacing
``_level_bwd_kernel``, level_bwd_kernel.py:68): a row pass
(:func:`fused_level_bwd_rows`) and three weight-gradient reductions
(:func:`level_bwd_reduce`, the kernel's ``dwi_ref += ...`` sums, :260-279),
or on the CPU :func:`fused_level_bwd_plain`, which writes K5's math out in
torch.
"""

from __future__ import annotations

import functools

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import pool_gather_plain
from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d, grid_sample_2d_adjoint
from tomosar2height_tpu_torch.ops.scatter import segment_counts, segment_mean
from tomosar2height_tpu_torch.ops.sorted_scatter import morton_to_plane, plane_to_morton


def level_shift(reso: int, finest: int) -> int:
    """Bits to drop from a finest Morton id to get this level's cell id."""
    return 2 * (int(finest).bit_length() - int(reso).bit_length())


def fused_level_plain(plane, c_last, weights, xy, cells, mask, reso: int,
                      finest: int):
    """The level round trip as plain torch ops. Same arguments and returns as
    :func:`fused_level`."""
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    sampled = grid_sample_2d(plane, xy)
    h = torch.relu(sampled @ w_in + b_in)
    o = (h @ w_out + b_out) + (c_last @ w_c + b_c)
    ncell = reso * reso
    cell_r = cells >> level_shift(reso, finest)
    valid = mask & (cells >= 0) & (cell_r < ncell)
    idx = torch.where(valid, cell_r, torch.zeros_like(cell_r))
    counts = segment_counts(idx, ncell, valid)
    plane_out = morton_to_plane(segment_mean(o, idx, ncell, valid, counts=counts), reso)
    c_out = torch.where(mask[..., None], o, torch.zeros_like(o))
    counts = morton_to_plane(counts, reso)[..., 0].to(torch.int32)
    return plane_out, c_out, counts


def fused_level_bwd_rows_plain(plane, c_last, weights, xy, cells, mask, counts, g_plane,
                               g_c, reso: int, finest: int):
    """K5's row pass in plain torch. Same arguments and returns as
    :func:`fused_level_bwd_rows`."""
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    r = plane.shape[1]
    s = grid_sample_2d(plane, xy)
    pre = s @ w_in + b_in
    h = torch.relu(pre)
    cell_r = cells >> level_shift(reso, finest)
    scaled = plane_to_morton(g_plane / counts.clamp_min(1).to(g_plane.dtype)[..., None])
    g_pt = pool_gather_plain(scaled, cell_r, mask & (cells >= 0))
    d_o = torch.where(mask[..., None], g_c + g_pt, torch.zeros_like(g_c))
    d_h = (d_o @ w_out.t()) * (pre > 0)
    d_s = d_h @ w_in.t()
    d_plane = grid_sample_2d_adjoint(d_s, xy, r, r)
    d_c_last = d_o @ w_c.t()

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    return d_plane, d_c_last, rows(s), rows(h), rows(d_o), rows(d_h)


def fused_level_bwd_plain(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c,
                          reso: int, finest: int):
    """K5's math in plain torch: the cotangents of :func:`fused_level` w.r.t.
    (plane, c_last, weights) for the output cotangents (g_plane, g_c), with
    the forward's counts. Same returns as :func:`fused_level_bwd`."""
    d_plane, d_c_last, s, h, d_o, d_h = fused_level_bwd_rows_plain(
        plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c, reso, finest)
    dw_in, db_in = level_bwd_reduce_plain(s, d_h, True)
    dw_out, db_out = level_bwd_reduce_plain(h, d_o, True)
    dw_c, _ = level_bwd_reduce_plain(c_last.reshape(-1, c_last.shape[-1]), d_o, False)
    return d_plane, d_c_last, (dw_in, db_in, dw_out, db_out, dw_c, db_out.clone())


def level_bwd_reduce_plain(a, b, bias: bool):
    """(a^T b, colsum(b) if ``bias`` else None) over the rows of (M, K) a and
    (M, N) b."""
    return a.t() @ b, (b.sum(0) if bias else None)


def _splits(m: int, k: int, n: int, device: torch.device) -> int:
    """Row splits of K5's weight-gradient reduction: two blocks an SM over
    the output's tiles (two waves of its one block an SM; the kernel picks
    the tile), at most one per 512 rows."""
    tiles = runtime.library().t2h_level_bwd_reduce_tiles(k, n)
    return max(1, min(2 * _sm_count(device.index) // tiles, -(-m // 512)))


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def level_bwd_reduce(a, b, bias: bool):
    """K5's second kernel, one weight gradient: the same returns as
    :func:`level_bwd_reduce_plain`, a hand-written split-K reduction over
    the rows on the tensor cores at fp32 accuracy (3xTF32;
    ``csrc/level_bwd.cu`` ``t2h_level_bwd_reduce``). Deterministic: the
    splits are summed in a fixed order."""
    if runtime.on_cpu(a):
        return level_bwd_reduce_plain(a, b, bias)
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    runtime.require(a, "a", torch.float32, (m, k), dev)
    runtime.require(b, "b", torch.float32, (m, n), dev)
    splits = _splits(m, k, n, dev)
    part = torch.empty(splits * (k + bias) * n, device=dev, dtype=torch.float32)
    dw = torch.empty((k, n), device=dev, dtype=torch.float32)
    db = torch.empty(n, device=dev, dtype=torch.float32) if bias else None
    err = runtime.library().t2h_level_bwd_reduce(
        a.data_ptr(), b.data_ptr(), m, k, n, splits, part.data_ptr(), dw.data_ptr(),
        db.data_ptr() if bias else None, runtime.stream_ptr(dev))
    runtime.check(err, "level_bwd_reduce")
    runtime.LAUNCHES["level_bwd_reduce"] += 1
    return dw, db


def fused_level_bwd_rows(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c,
                         reso: int, finest: int):
    """K5's row pass (``t2h_fused_level_bwd``): d_plane, d_c_last and the
    rows the weight gradients need, on the tensor cores at fp32 accuracy
    (3xTF32), 64 rows a block.

    Args: the forward's inputs, its counts (B, R, R) int32, and the output
    cotangents g_plane (B, R, R, F), g_c (B, N, F), all f32 and contiguous.

    Returns:
        d_plane (B, R, R, F), d_c_last (B, N, Fl), and the rows (M = B*N):
        s (M, F) the recomputed sample, h (M, 2F), d_o (M, F), d_h (M, 2F).
        Padding rows weigh 0 in every gradient (d_o and d_h are 0 there);
        the kernel's s is 0 there too, the plain version samples them.

    Takes F <= 512 and any Fl: its shared memory (219 KB at F = 512) does
    not grow with Fl. Allocates the 6F floats a row of those rows: ~2 GB at
    the flagship's F=512 level.
    """
    if runtime.on_cpu(plane):
        return fused_level_bwd_rows_plain(plane, c_last, weights, xy, cells, mask, counts,
                                          g_plane, g_c, reso, finest)
    dev = plane.device
    b, r, _, f = plane.shape
    n, fl = c_last.shape[1], c_last.shape[-1]
    h = 2 * f
    w_in, b_in, w_out, _, w_c, _ = weights
    f32 = torch.float32
    _check_level(plane, c_last, weights, xy, cells, mask, reso)
    runtime.require(counts, "counts", torch.int32, (b, r, r), dev)
    runtime.require(g_plane, "g_plane", f32, (b, r, r, f), dev)
    runtime.require(g_c, "g_c", f32, (b, n, f), dev)
    m = b * n
    new = lambda *shape: torch.empty(shape, device=dev, dtype=f32)  # noqa: E731
    w_out_t, w_c_t, w_in_t = (w.t().contiguous() for w in (w_out, w_c, w_in))
    d_plane, d_c_last = new(b, r, r, f), new(b, n, fl)
    s, hs, d_o, d_h = new(m, f), new(m, h), new(m, f), new(m, h)
    err = runtime.library().t2h_fused_level_bwd(
        plane.data_ptr(), xy.data_ptr(), cells.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), g_plane.data_ptr(), g_c.data_ptr(), w_in.data_ptr(),
        b_in.data_ptr(), w_out_t.data_ptr(), w_c_t.data_ptr(), w_in_t.data_ptr(),
        d_plane.data_ptr(), d_c_last.data_ptr(), s.data_ptr(), hs.data_ptr(),
        d_o.data_ptr(), d_h.data_ptr(), b, n, r, f, fl, level_shift(reso, finest),
        runtime.stream_ptr(dev))
    runtime.check(err, "fused_level_bwd")
    runtime.LAUNCHES["fused_level_bwd"] += 1
    return d_plane, d_c_last, s, hs, d_o, d_h


def fused_level_bwd(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c,
                    reso: int, finest: int):
    """K5: the backward of :func:`fused_level`. One row pass
    (:func:`fused_level_bwd_rows`: d_plane, d_c_last and the rows the weight
    gradients need), then three :func:`level_bwd_reduce` calls.

    Args: the forward's inputs, its counts (B, R, R) int32, and the output
    cotangents g_plane (B, R, R, F), g_c (B, N, F), all f32 and contiguous.

    Returns:
        d_plane (B, R, R, F), d_c_last (B, N, Fl), and the weight cotangents
        (dw_in, db_in, dw_out, db_out, dw_c, db_c), db_c equal to db_out
        (both biases add into o).

    The row pass's 6F floats of scratch a row (B*N rows), ~2 GB at the
    flagship's F=512 level, are freed on return.
    """
    if runtime.on_cpu(plane):
        return fused_level_bwd_plain(plane, c_last, weights, xy, cells, mask, counts,
                                     g_plane, g_c, reso, finest)
    d_plane, d_c_last, s, hs, d_o, d_h = fused_level_bwd_rows(
        plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c, reso, finest)
    dw_in, db_in = level_bwd_reduce(s, d_h, True)
    dw_out, db_out = level_bwd_reduce(hs, d_o, True)
    dw_c, _ = level_bwd_reduce(c_last.reshape(-1, c_last.shape[-1]), d_o, False)
    return d_plane, d_c_last, (dw_in, db_in, dw_out, db_out, dw_c, db_out.clone())


class _FusedLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, c_last, xy, cells, mask, reso: int, finest: int, *weights):
        plane_out, c_out, counts = _fused_level(plane, c_last, weights, xy, cells, mask,
                                                reso, finest)
        ctx.mark_non_differentiable(counts)
        # save_for_backward (not ctx attributes): non-reentrant checkpointing
        # drops these and recomputes them in the backward
        ctx.save_for_backward(plane, c_last, xy, cells, mask, counts, *weights)
        ctx.reso, ctx.finest = reso, finest
        return plane_out, c_out, counts

    @staticmethod
    def backward(ctx, g_plane, g_c, _g_counts):
        plane, c_last, xy, cells, mask, counts, *weights = ctx.saved_tensors
        d_plane, d_c_last, dw = fused_level_bwd(
            plane, c_last, tuple(weights), xy, cells, mask, counts,
            g_plane.contiguous(), g_c.contiguous(), ctx.reso, ctx.finest)
        return (d_plane, d_c_last, None, None, None, None, None, *dw)


def fused_level(plane, c_last, weights, xy, cells, mask, reso: int, finest: int):
    """K4: one ALTO level round trip on the Morton-aligned layout;
    differentiable in plane, c_last and weights (backward: K5,
    :func:`fused_level_bwd`).

    Args:
        plane: (B, R, R, F) f32 NHWC plane (post-convs), R == ``reso``.
        c_last: (B, N, Fl) f32 previous level's point features.
        weights: (w_in (F, 2F), b_in (2F,), w_out (2F, F), b_out (F,),
            w_c (Fl, F), b_c (F,)), f32, row-major (in, out).
        xy: (B, N, 2) f32 point coordinates in [0, 1].
        cells: (B, N) int32 finest Morton ids (PAD_CELL_SENTINEL on pads).
        mask: (B, N) bool validity.
        reso: this level's plane resolution; finest: the layout's.

    Returns:
        plane_out (B, R, R, F) scatter-mean of the new point features (empty
        cells 0), c_out (B, N, F) new point features (0 on masked rows),
        counts (B, R, R) int32 points per cell.

    K4 runs its three products on the tensor cores at fp32 accuracy
    (3xTF32, ``csrc/mma_tf32x3.cuh``), 64 points a block; it takes F <= 512
    and any Fl (c_last is contracted in K-chunks of F's width rounded up to
    a power of two, so Fl = 1024 at the first up level of a depth-6 U-Net
    fits); a wider F raises. K5 takes the same F and Fl.
    """
    return _FusedLevel.apply(plane, c_last, xy, cells, mask, reso, finest, *weights)


def _check_level(plane, c_last, weights, xy, cells, mask, reso: int) -> None:
    dev = plane.device
    b, r, _, f = plane.shape
    if r != reso:
        raise ValueError(f"plane resolution {r} != reso {reso}")
    n, fl = c_last.shape[1], c_last.shape[-1]
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    f32 = torch.float32
    runtime.require(plane, "plane", f32, (b, r, r, f), dev)
    runtime.require(c_last, "c_last", f32, (b, n, fl), dev)
    runtime.require(xy, "xy", f32, (b, n, 2), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    runtime.require(w_in, "w_in", f32, (f, 2 * f), dev)
    runtime.require(b_in, "b_in", f32, (2 * f,), dev)
    runtime.require(w_out, "w_out", f32, (2 * f, f), dev)
    runtime.require(b_out, "b_out", f32, (f,), dev)
    runtime.require(w_c, "w_c", f32, (fl, f), dev)
    runtime.require(b_c, "b_c", f32, (f,), dev)


def _fused_level(plane, c_last, weights, xy, cells, mask, reso: int, finest: int):
    if runtime.on_cpu(plane):
        return fused_level_plain(plane, c_last, weights, xy, cells, mask, reso,
                                 finest)
    _check_level(plane, c_last, weights, xy, cells, mask, reso)
    dev = plane.device
    b, r, _, f = plane.shape
    n, fl = c_last.shape[1], c_last.shape[-1]
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    f32 = torch.float32
    lib = runtime.library()
    plane_out = torch.empty((b, r, r, f), device=dev, dtype=f32)
    c_out = torch.empty((b, n, f), device=dev, dtype=f32)
    counts = torch.empty((b, r, r), device=dev, dtype=torch.int32)
    err = lib.t2h_fused_level(
        plane.data_ptr(), c_last.data_ptr(), xy.data_ptr(), cells.data_ptr(),
        mask.data_ptr(), w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), w_c.data_ptr(), b_c.data_ptr(), plane_out.data_ptr(),
        c_out.data_ptr(), counts.data_ptr(), b, n, r, f, fl,
        level_shift(reso, finest), runtime.stream_ptr(dev))
    runtime.check(err, "fused_level")
    runtime.LAUNCHES["fused_level"] += 1
    return plane_out, c_out, counts
