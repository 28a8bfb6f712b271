"""Masked point -> grid segment reductions as plain torch ops.

Counterpart of ``tomosar2height_tpu/ops/scatter.py`` (torch_scatter semantics
of the reference: pointnet.py:92-111, alto.py:76-95):
- the cell of a point at normalized (x, y) is ``floor(x*reso) + reso*floor(y*reso)``,
  clipped to the plane;
- the mean and the max of an empty cell are 0 (not -inf);
- masked (padded) points reach no cell.

Batch entries fold into the segment axis (``b * num_segments + cell``); masked
points go to trash segments that are dropped after the reduction.

These are the unsorted point path's ops (the default ``dataset.points.sort:
false``), and on the card that path is the yardstick the kernel paths are
held to, so they stay plain torch and not the port's run kernels (which
would then be held to themselves). On CUDA, ``index_add_`` and the backward
of ``torch.gather`` (a ``scatter_add_``) add with float atomics, in an order
that changes from run to run. So every such add here runs under
:func:`fixed_order`: torch's deterministic implementations of these ops (on
CUDA both become a stable sort of the rows by destination and a sum over
each destination's rows in row order), switched on for the op alone, in its
forward and in its backward (:class:`_GatherRows`), and switched back to
what it was after. The mode is not set for a whole step: there it would
make other ops' CUDA backwards raise (``F.interpolate``'s, the float
``cumsum``'s) and fill every ``torch.empty`` with NaN. On the CPU these ops
already add in row order and the mode changes nothing: the results are the
bits they were. bf16 values keep their rounding points: each add rounds to
bf16, in row order. ``segment_max``'s ``scatter_reduce(amax)`` is left as it
is: its forward does not depend on the order, and its backward counts ties
with sums of zeros and ones, which are exact.

A sum in a fixed order adds a segment's rows one after another (on CUDA,
one warp walks them). So no segment may collect a batch's padding: masked
rows are spread over TRASH_ROWS dropped rows, and the gathers' backwards
(``gather_cells``, ``sampling.grid_sample_2d``) take a mask whose rows they
leave out, where the caller's masked rows reach nothing (their cotangents
are zeros; the unsorted path's padding rows all sit at (0, 0)).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.utils.deterministic


@contextlib.contextmanager
def fixed_order():
    """torch's deterministic algorithms for the ops inside, then the mode
    (and its ``warn_only``) as it was before, also after an exception.
    Uninitialized memory is not filled with NaN meanwhile (the ops inside
    write all they allocate)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def index_add_rows(out: torch.Tensor, index: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, rows)`` under :func:`fixed_order`; its
    backward (``index_select`` of the cotangent) has no adds."""
    with fixed_order():
        return out.index_add_(0, index, rows)


TRASH_ROWS = 4096
"""Rows that masked rows are spread over (row id modulo TRASH_ROWS), after
the real segments, and dropped: a fixed-order sum adds a segment's rows one
after another, so the masked rows of a whole batch in one segment would make
one long chain (on CUDA, one warp walking them all)."""


def flat_segments(index: torch.Tensor, mask: Optional[torch.Tensor],
                  num_segments: int) -> torch.Tensor:
    """(B * N,) segment ids ``b * num_segments + index``; a masked row's
    among the TRASH_ROWS rows after the B * num_segments real ones."""
    b, n = index.shape
    offset = torch.arange(b, device=index.device, dtype=torch.int64) * num_segments
    seg = index.long() + offset[:, None]
    if mask is not None:
        trash = b * num_segments + torch.arange(b * n, device=index.device).reshape(b, n) \
            % TRASH_ROWS
        seg = torch.where(mask, seg, trash)
    return seg.reshape(-1)


class _GatherRows(torch.autograd.Function):
    """``torch.gather`` of (B, S, C) rows at (B, N) ids, whose backward adds
    each row's cotangent into its source row with :func:`index_add_rows`
    over the flattened (B * S, C) rows: the sum autograd's ``scatter_add_``
    makes, in the same row order, with one sort of the B * N row ids on the
    card instead of one of all B * N * C elements. With a (B, N) ``mask``
    the backward adds only the rows it keeps: for callers whose masked rows'
    outputs reach nothing (their cotangents are zeros), so that the padding
    rows, which all sit at one point, do not make one long chain of adds."""

    @staticmethod
    def forward(ctx, src, index, mask):
        ctx.save_for_backward(index, mask)
        ctx.shape = src.shape
        c = src.shape[-1]
        return torch.gather(src, 1, index[..., None].expand(*index.shape, c))

    @staticmethod
    def backward(ctx, g):
        index, mask = ctx.saved_tensors
        b, s, c = ctx.shape
        rows = flat_segments(index, mask, s)
        out = g.new_zeros(b * s + (TRASH_ROWS if mask is not None else 0), c)
        out = index_add_rows(out, rows, g.reshape(-1, c))
        return out[: b * s].reshape(b, s, c), None, None


def cell_index(coords: torch.Tensor, reso: int) -> torch.Tensor:
    """(..., 2) xy in [0, 1] -> (...,) int64 row-major cell ids in [0, reso**2)."""
    xi = (coords * reso).to(torch.int32).clamp(0, reso - 1).long()
    return xi[..., 0] + reso * xi[..., 1]


def cell_matrix(coords: torch.Tensor, reso: int, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, N, reso**2) membership of each valid point in its cell
    (:func:`cell_index`): 1 at its cell, a masked point's row all 0. Its
    transpose times (B, N, C) values sums each cell, a dense product in a
    fixed order."""
    b, n = mask.shape
    idx = cell_index(coords, reso)[..., None]
    out = torch.zeros(b, n, reso * reso, device=coords.device, dtype=dtype)
    return out.scatter_(2, idx, mask[..., None].to(dtype))


def segment_counts(index: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, num_segments, 1) f32 per-cell point counts."""
    b, n = index.shape
    seg = flat_segments(index, mask, num_segments)
    ones = torch.ones(b * n, device=index.device, dtype=torch.float32)
    counts = index_add_rows(torch.zeros(b * num_segments + TRASH_ROWS, device=index.device,
                                        dtype=torch.float32), seg, ones)
    return counts[: b * num_segments].reshape(b, num_segments, 1)


def segment_sum(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked per-cell sum of (B, N, C) values -> (B, num_segments, C)."""
    b, n, c = values.shape
    seg = flat_segments(index, mask, num_segments)
    sums = index_add_rows(torch.zeros(b * num_segments + TRASH_ROWS, c, device=values.device,
                                      dtype=values.dtype), seg, values.reshape(b * n, c))
    return sums[: b * num_segments].reshape(b, num_segments, c)


def segment_mean(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor] = None,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked per-cell mean of (B, N, C) values -> (B, num_segments, C)."""
    sums = segment_sum(values, index, num_segments, mask)
    if counts is None:
        counts = segment_counts(index, num_segments, mask)
    return sums / counts.to(sums.dtype).clamp_min(1.0)


def segment_max(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked per-cell max -> (B, num_segments, C); empty cells get 0."""
    b, n, c = values.shape
    seg = flat_segments(index, mask, num_segments)
    maxs = torch.full((b * num_segments + TRASH_ROWS, c), float("-inf"),
                      device=values.device, dtype=values.dtype)
    maxs = maxs.scatter_reduce(0, seg[:, None].expand(b * n, c),
                               values.reshape(b * n, c), reduce="amax",
                               include_self=True)
    maxs = torch.where(torch.isfinite(maxs), maxs, torch.zeros_like(maxs))
    return maxs[: b * num_segments].reshape(b, num_segments, c)


def gather_cells(planes_flat: torch.Tensor, index: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-point gather-back: (B, S, C) cell (or pixel) values, (B, N) ids ->
    (B, N, C), differentiable, its backward in a fixed order, over the rows
    ``mask`` keeps where one is given (:class:`_GatherRows`)."""
    return _GatherRows.apply(planes_flat, index.long(), mask)


def pool_local_max(values: torch.Tensor, index: torch.Tensor, reso: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scatter_max into reso**2 cells, then gather back per point
    (reference pointnet.py:92-99). Masked rows get their cell's value but
    take no part in the backward: they reach nothing downstream."""
    return gather_cells(segment_max(values, index, reso * reso, mask), index, mask)


def pool_local_mean(values: torch.Tensor, index: torch.Tensor, reso: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scatter_mean variant of :func:`pool_local_max`."""
    return gather_cells(segment_mean(values, index, reso * reso, mask), index, mask)

