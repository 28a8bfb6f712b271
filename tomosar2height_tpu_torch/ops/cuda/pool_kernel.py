"""Fused local pooling on the aligned layout with 256-cell tiles: K10.

Counterpart of ``tomosar2height_tpu/ops/pallas/pool_kernel.py``. K10 replaces
``_pool_kernel`` (pool_kernel.py:36, launched by ``_pool_impl``,
``pallas_tile_pool``): each row of tile t's range whose finest Morton id lies
in the tile's 256 cells reduces into its cell (max or mean, an empty cell 0),
and reads the cell's value back; the other rows (pads, rows of another tile,
and rows past the last tile's range, which the TPU kernel leaves undefined)
give 0. It runs on pool2's run kernel (``csrc/pool2.cu`` ``pool_runs``, C
entry ``t2h_pool_runs``) with the tile check in place of the mask: one
atomic-free pass over the Morton-sorted runs, each run reduced in row order
by one warp and written back to its rows, so both kinds are bit-equal run to
run. Its contract is the fused layout's: each cell's rows are contiguous
(``ops/sorted_scatter.host_morton_bucket_aligned``: rows Morton-sorted, pads
only at tile ends). The TPU kernel's id lane and one-hot matmuls exist for
the MXU; the kernel here reads the ids as they are. A CPU tensor takes
:func:`tile_pool_plain`, a CUDA tensor the kernel; there is no fallback.
Differentiable through :func:`tomosar2height_tpu_torch.ops.fused.tile_pool`.
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.cuda.scatter_kernel import TILE_CELLS, tile_rows
from tomosar2height_tpu_torch.ops.scatter import gather_cells, segment_max, segment_mean

_KINDS = {"max": 0, "mean": 1}


def tile_pool_plain(values, cells, tile_offsets, kind: str) -> torch.Tensor:
    """K10's function: (B, Npad, F) values, (B, Npad) finest ids, (B, T + 1)
    tile offsets -> (B, Npad, F) per-row cell max/mean, 0 on rows outside
    their tile's cells."""
    ncell = (tile_offsets.shape[1] - 1) * TILE_CELLS
    idx, valid = tile_rows(cells, tile_offsets, 0, ncell)
    reduce = segment_max if kind == "max" else segment_mean
    out = gather_cells(reduce(values, idx, ncell, valid), idx)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def tile_pool(values, cells, tile_offsets, kind: str) -> torch.Tensor:
    """K10: the same arguments and return as :func:`tile_pool_plain`; on a
    CUDA tensor values (B, Npad, F) f32, cells (B, Npad) int32 and
    tile_offsets (B, T + 1) int32, all contiguous, each cell's rows contiguous
    (module docstring). Not differentiable itself: the model calls it through
    ``ops.fused.tile_pool``."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be 'max' or 'mean', got {kind!r}")
    if runtime.on_cpu(values):
        return tile_pool_plain(values, cells, tile_offsets, kind)
    dev = values.device
    b, n, f = values.shape
    t = tile_offsets.shape[1] - 1
    runtime.require(values, "values", torch.float32, (b, n, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(tile_offsets, "tile_offsets", torch.int32, (b, t + 1), dev)
    out = torch.empty((b, n, f), device=dev, dtype=torch.float32)
    err = runtime.library().t2h_pool_runs(
        values.data_ptr(), cells.data_ptr(), 0, tile_offsets.data_ptr(), 0, 0,
        out.data_ptr(), b, n, f, t * TILE_CELLS, _KINDS[kind], runtime.stream_ptr(dev))
    runtime.check(err, "tile_pool")
    runtime.LAUNCHES["tile_pool"] += 1
    return out
