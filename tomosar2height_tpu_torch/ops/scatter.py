"""Masked point -> grid segment reductions as plain torch ops.

Counterpart of ``tomosar2height_tpu/ops/scatter.py`` (torch_scatter semantics
of the reference: pointnet.py:92-111, alto.py:76-95):
- the cell of a point at normalized (x, y) is ``floor(x*reso) + reso*floor(y*reso)``,
  clipped to the plane;
- the mean and the max of an empty cell are 0 (not -inf);
- masked (padded) points reach no cell.

Batch entries fold into the segment axis (``b * num_segments + cell``); masked
points go to one trash segment that is dropped after the reduction.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def _flat_segments(index: torch.Tensor, mask: Optional[torch.Tensor],
                   num_segments: int) -> torch.Tensor:
    b, _ = index.shape
    offset = torch.arange(b, device=index.device, dtype=torch.int64) * num_segments
    seg = index.long() + offset[:, None]
    if mask is not None:
        seg = torch.where(mask, seg, torch.full_like(seg, b * num_segments))
    return seg.reshape(-1)


def segment_counts(index: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, num_segments, 1) f32 per-cell point counts."""
    b, n = index.shape
    seg = _flat_segments(index, mask, num_segments)
    ones = torch.ones(b * n, device=index.device, dtype=torch.float32)
    counts = torch.zeros(b * num_segments + 1, device=index.device,
                         dtype=torch.float32).index_add_(0, seg, ones)
    return counts[: b * num_segments].reshape(b, num_segments, 1)


def segment_sum(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked per-cell sum of (B, N, C) values -> (B, num_segments, C)."""
    b, n, c = values.shape
    seg = _flat_segments(index, mask, num_segments)
    sums = torch.zeros(b * num_segments + 1, c, device=values.device,
                       dtype=values.dtype).index_add_(0, seg, values.reshape(b * n, c))
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
    seg = _flat_segments(index, mask, num_segments)
    maxs = torch.full((b * num_segments + 1, c), float("-inf"),
                      device=values.device, dtype=values.dtype)
    maxs = maxs.scatter_reduce(0, seg[:, None].expand(b * n, c),
                               values.reshape(b * n, c), reduce="amax",
                               include_self=True)
    maxs = torch.where(torch.isfinite(maxs), maxs, torch.zeros_like(maxs))
    return maxs[: b * num_segments].reshape(b, num_segments, c)


def gather_cells(planes_flat: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Per-point gather-back: (B, S, C) cell values, (B, N) ids -> (B, N, C)."""
    c = planes_flat.shape[-1]
    idx = index.long()[..., None].expand(*index.shape, c)
    return torch.gather(planes_flat, 1, idx)


def pool_local_max(values: torch.Tensor, index: torch.Tensor, reso: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scatter_max into reso**2 cells, then gather back per point
    (reference pointnet.py:92-99)."""
    return gather_cells(segment_max(values, index, reso * reso, mask), index)


def pool_local_mean(values: torch.Tensor, index: torch.Tensor, reso: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scatter_mean variant of :func:`pool_local_max`."""
    return gather_cells(segment_mean(values, index, reso * reso, mask), index)

