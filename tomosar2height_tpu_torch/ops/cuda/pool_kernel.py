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

Its backward (:func:`tile_pool_bwd`) is the same kernel again, as the JAX
``_tile_pool_bwd`` (``ops/pallas/fused.py:118``, the vjp of ``segment_max``/
``segment_mean`` and the gather-back) computes it: for 'mean' the run mean
of the cotangent (K10's forward on g); for 'max' the run's cotangent sum
split evenly among the run's rows that tie with the max, feature by
feature (``t2h_pool_runs`` kind 3: the tie gate counts them, no atomics).
pool2's backward on fused2 gives each tied row the whole sum instead (the
JAX pool2's rule); the two layouts keep their packages' rules.

bf16 values (the model's bf16 dtype) take the run kernel's bf16 instance
(``t2h_pool_runs_bf16``; counted under ``tile_pool_bf16`` and
``tile_pool_bwd_bf16``) and the JAX kernel's rule with bf16 values
(pool_kernel.py:111-150): the max exact (the scan in f32, cast back), the
mean an f32 sum over f32 counts rounded to bf16 once, the cell values
gathered back in bf16. The backward sums the cotangent in f32 and rounds
each row's share once, ties compared in f32; JAX's vjp (``_pool_ref``'s
segment_max/segment_mean in bf16 through XLA) rounds its sums in bf16 as it
goes, so the two differ by more than an ulp on long runs: held to JAX's
bf16 gate (``tests/test_torch_bf16_tiles.py``).
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import (
    acc_dtype,
    check_runs_plan,
    value_dtype,
)
from tomosar2height_tpu_torch.ops.cuda.scatter_kernel import TILE_CELLS, tile_rows
from tomosar2height_tpu_torch.ops.scatter import (
    gather_cells,
    segment_max,
    segment_mean,
    segment_sum,
)

_KINDS = {"max": 0, "mean": 1}
_SPLIT = 3  # t2h_pool_runs: the run sum split among its tied rows


def tile_pool_plain(values, cells, tile_offsets, kind: str) -> torch.Tensor:
    """K10's function: (B, Npad, F) values, (B, Npad) finest ids, (B, T + 1)
    tile offsets -> (B, Npad, F) per-row cell max/mean in the values' dtype
    (reduced in float32 for bf16, rounded once), 0 on rows outside their
    tile's cells."""
    ncell = (tile_offsets.shape[1] - 1) * TILE_CELLS
    idx, valid = tile_rows(cells, tile_offsets, 0, ncell)
    reduce = segment_max if kind == "max" else segment_mean
    cellv = reduce(acc_dtype(values), idx, ncell, valid).to(values.dtype)
    out = gather_cells(cellv, idx)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def tile_pool(values, cells, tile_offsets, kind: str) -> torch.Tensor:
    """K10: the same arguments and return as :func:`tile_pool_plain`; on a
    CUDA tensor values (B, Npad, F) f32 or bf16, cells (B, Npad) int32 and
    tile_offsets (B, T + 1) int32, all contiguous, each cell's rows contiguous
    (module docstring): one launch of ``t2h_pool_runs`` (``_bf16``) with the
    tile offsets and no mask. Not differentiable itself: the model calls it
    through ``ops.fused.tile_pool``."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be 'max' or 'mean', got {kind!r}")
    if runtime.on_cpu(values):
        return tile_pool_plain(values, cells, tile_offsets, kind)
    dev, dt = values.device, value_dtype("values", values)
    b, n, f = values.shape
    t = tile_offsets.shape[1] - 1
    runtime.require(values, "values", dt, (b, n, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(tile_offsets, "tile_offsets", torch.int32, (b, t + 1), dev)
    out = torch.empty((b, n, f), device=dev, dtype=dt)
    check_runs_plan(values, out, _KINDS[kind], True)
    err = runtime.entry("pool_runs", dt)(
        values.data_ptr(), cells.data_ptr(), 0, tile_offsets.data_ptr(), 0, 0,
        out.data_ptr(), b, n, f, t * TILE_CELLS, _KINDS[kind], runtime.stream_ptr(dev))
    runtime.check(err, "tile_pool")
    runtime.launched("tile_pool", dt)
    return out


def tile_pool_bwd_plain(g, values, out, cells, tile_offsets, kind: str) -> torch.Tensor:
    """The cotangent of :func:`tile_pool_plain` w.r.t. ``values`` at ``g``
    (B, Npad, F), ``out`` its forward, written out as autograd computes it
    (and JAX's segment_max/segment_mean vjps): 'mean' -> the mean pool of g;
    'max' -> each cell's sum of g over its valid rows, split evenly among the
    rows where ``values == out``, feature by feature, 0 on the others. bf16:
    the sums in float32, each share rounded to bf16 once."""
    ncell = (tile_offsets.shape[1] - 1) * TILE_CELLS
    idx, valid = tile_rows(cells, tile_offsets, 0, ncell)
    g = torch.where(valid[..., None], g, torch.zeros_like(g))
    if kind == "mean":
        return tile_pool_plain(g, cells, tile_offsets, "mean")
    tied = valid[..., None] & (values == out)
    wide = acc_dtype(g)
    sums = segment_sum(wide, idx, ncell, valid)
    ties = segment_sum(tied.to(wide.dtype), idx, ncell, valid)
    share = gather_cells((sums / ties.clamp_min(1.0)).to(g.dtype), idx)
    return torch.where(tied, share, torch.zeros_like(share))


def tile_pool_bwd(g, values, out, cells, tile_offsets, kind: str) -> torch.Tensor:
    """K10's backward, one launch of the run kernel under the tile rule:
    'mean' -> the run mean of ``g``; 'max' -> the run sum of ``g`` divided by
    the number of the run's rows where ``values == out`` (``out`` K10's
    forward), on those rows, 0 elsewhere. Shapes and dtypes as
    :func:`tile_pool`, all four value tensors in one dtype. Counted in
    ``LAUNCHES['tile_pool_bwd']`` (``_bf16``)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be 'max' or 'mean', got {kind!r}")
    if runtime.on_cpu(g):
        return tile_pool_bwd_plain(g, values, out, cells, tile_offsets, kind)
    dev, dt = g.device, value_dtype("g", g)
    b, n, f = g.shape
    t = tile_offsets.shape[1] - 1
    for name, x in (("g", g), ("values", values), ("out", out)):
        runtime.require(x, name, dt, (b, n, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(tile_offsets, "tile_offsets", torch.int32, (b, t + 1), dev)
    dv = torch.empty((b, n, f), device=dev, dtype=dt)
    tie = kind == "max"
    run_kind = _SPLIT if tie else _KINDS["mean"]
    check_runs_plan(g, dv, run_kind, True, (values, out) if tie else ())
    err = runtime.entry("pool_runs", dt)(
        g.data_ptr(), cells.data_ptr(), 0, tile_offsets.data_ptr(),
        values.data_ptr() if tie else 0, out.data_ptr() if tie else 0, dv.data_ptr(), b, n,
        f, t * TILE_CELLS, run_kind, runtime.stream_ptr(dev))
    runtime.check(err, "tile_pool_bwd")
    runtime.launched("tile_pool_bwd", dt)
    return dv
