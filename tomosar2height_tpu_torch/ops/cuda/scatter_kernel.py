"""Scatter-mean of Morton-tile-grouped rows: K11, K12, K13 and K14.

Counterpart of ``tomosar2height_tpu/ops/pallas/scatter_kernel.py``. Its four
Pallas kernels compute one function on one contract: rows grouped by 16x16
Morton tile (256 cells), each tile's rows contiguous; a row adds into cell
``(cell >> shift) - 256 t`` of its tile t when that lies in [0, 256), else
nowhere (pad rows, ``PAD_CELL_SENTINEL``, rows of another tile); each cell's
mean is written, 0 for an empty cell. One CUDA kernel computes it, and
each TPU kernel keeps its own launcher, plain version and launch count:
``csrc/pool2.cu`` ``t2h_scatter_runs``, K3's atomic-free pass over the
Morton-sorted runs with the tile check on (a warp sums each run in row
order and writes its cell once; the empty cells, marked first, are zeroed
in the same launch: bit-equal run to run). K11 and K13 read their tile
offsets in place, every 256th of the per-cell offsets (step 256), K12 its
tile offsets at this resolution (step 1), K14 every 4**level-th of the
finest tile offsets (step 4**level); K13 stores each cell at its Morton
index (``morton``), the others at its row-major one. Their contract: a
cell's rows at this resolution are contiguous (the plain sorted layout's
rows are sorted, pads at the end; on the fused layout true down to 16^2,
where a cell is one finest 256-cell tile, pads only between cells).

- K11 :func:`scatter_mean_plane` <- ``_scatter_tile_kernel_plane``
  (scatter_kernel.py:124, ``pallas_scatter_mean_plane``): the plain sorted
  layout (per-cell offsets, pads at ``reso*reso``) -> row-major plane;
- K12 :func:`aligned_scatter_mean_plane` <- ``_aligned_scatter_kernel``
  (scatter_kernel.py:242, ``pallas_aligned_scatter_mean_plane``): the aligned
  layout, tile offsets at this resolution, finest ids shifted by 2*level;
- K13 :func:`scatter_mean` <- ``_scatter_tile_kernel`` (scatter_kernel.py:65,
  ``pallas_scatter_mean``): as K11, Morton-ordered (B, reso*reso, C) output;
- K14 :func:`scatter_mean_plane_v3` <- ``_scatter_v3_kernel``
  (scatter_kernel.py:495, ``pallas_scatter_mean_plane_v3``): K12's function
  from the finest tile offsets, read in place every 4**level-th.

A CPU tensor takes the plain version (``*_plain``: a masked segment mean over
the rows that belong to their tile), a CUDA tensor the kernel; there is no
fallback. K11, K13 and K14 are forward-only, as the JAX functions are (bare
``jax.jit``s with no vjp): they raise when a gradient is asked for. K12 is
differentiable through :func:`tomosar2height_tpu_torch.ops.fused.tile_scatter_mean`:
its forward then also writes the cells' counts, and its backward
(:func:`aligned_scatter_mean_plane_bwd`, the JAX ``_tile_scatter_bwd``,
``ops/pallas/fused.py:149``: each row takes its cell's plane cotangent over
the cell's count, pad rows 0) is K2 alone (``csrc/pool2.cu``
``pool_gather``) at the level's shift with no mask: a warp a 32-row span,
each run's cell read once, each row written once.

bf16 values (the model's bf16 dtype) take the run scatter's bf16 instance
(``t2h_scatter_runs_bf16``; counted under ``<name>_bf16``) and the JAX
kernels' rule with bf16 values: each cell's sum of the (exact) bf16 values
in f32 over its f32 count, the mean rounded to bf16 once, the output bf16
(scatter_kernel.py:108-121,155-175 sum f32 copies; :301-317 a bf16 one-hot
into f32; K14 :613-624). K12's backward in bf16 follows JAX's
``_tile_scatter_bwd`` (fused.py:149-173): the bf16 cotangent divided by
the count cast to bf16 (a count above 256 takes the nearest bf16, as JAX's
does), the quotient rounded once: ``t2h_pool_gather_cut_bf16``, K2's
instance with the count cut, which fused2's K2 does not take.
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.cuda.level_kernel import level_shift
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import acc_dtype, value_dtype
from tomosar2height_tpu_torch.ops.scatter import segment_counts, segment_mean
from tomosar2height_tpu_torch.ops.sorted_scatter import morton_to_plane, plane_to_morton

TILE_CELLS = 256
"""Cells of a 16x16 Morton tile."""


# --- plain versions ---------------------------------------------------------------


def tile_rows(cells, toff, shift: int, ncell: int):
    """(index, valid) of (B, N) rows under (B, T + 1) tile offsets: each
    row's cell ``cells >> shift`` (0 where invalid), and whether that cell
    lies in the 256-cell tile whose row range holds the row."""
    b, n = cells.shape
    toff = toff.to(torch.int32).contiguous()
    rows = torch.arange(n, device=cells.device, dtype=torch.int32).expand(b, n).contiguous()
    row_tile = torch.searchsorted(toff, rows, right=True) - 1
    cell = cells.long() >> shift
    valid = (cells >= 0) & (cell < ncell) & (cell // TILE_CELLS == row_tile)
    return torch.where(valid, cell, torch.zeros_like(cell)), valid


def _tile_mean_plain(values, cells, toff, reso: int, shift: int, morton_out: bool,
                     with_counts: bool = False):
    """The shared function over tile offsets ``toff`` (B, T + 1), in the
    values' dtype (bf16: the means in float32, rounded once); with
    ``with_counts`` also the row-major (B, reso, reso) int32 counts."""
    ncell = reso * reso
    idx, valid = tile_rows(cells, toff, shift, ncell)
    counts = segment_counts(idx, ncell, valid)
    vec = segment_mean(acc_dtype(values), idx, ncell, valid, counts=counts).to(values.dtype)
    out = vec if morton_out else morton_to_plane(vec, reso)
    if with_counts:
        return out, morton_to_plane(counts, reso)[..., 0].to(torch.int32)
    return out


def scatter_mean_plane_plain(values, cells, offsets, reso: int):
    """K11's function: (B, N, C) values, (B, N) ids at ``reso``, (B, reso**2 + 1)
    per-cell offsets -> (B, reso, reso, C) row-major plane."""
    return _tile_mean_plain(values, cells, offsets[:, ::TILE_CELLS], reso, 0, False)


def scatter_mean_plain(values, cells, offsets, reso: int):
    """K13's function: as :func:`scatter_mean_plane_plain`, Morton-ordered
    (B, reso**2, C)."""
    return _tile_mean_plain(values, cells, offsets[:, ::TILE_CELLS], reso, 0, True)


def aligned_scatter_mean_plane_plain(values, cells, tile_offsets, reso: int, finest: int,
                                     with_counts: bool = False):
    """K12's function: (B, Npad, F) values, (B, Npad) finest ids, (B, T + 1)
    tile offsets at ``reso`` -> (B, reso, reso, F), and with ``with_counts``
    the (B, reso, reso) int32 counts."""
    return _tile_mean_plain(values, cells, tile_offsets, reso, level_shift(reso, finest),
                            False, with_counts)


def aligned_scatter_mean_plane_bwd_plain(g_plane, cells, counts, reso: int,
                                         finest: int) -> torch.Tensor:
    """K12's backward written out as the JAX ``_tile_scatter_bwd``: each row
    whose cell ``cells >> shift`` is in range takes ``g_plane`` at its cell
    over max(count, 1), the count in g_plane's dtype (bf16: rounded, and the
    quotient rounded once); pad rows 0. g_plane (B, reso, reso, F), counts
    (B, reso, reso) -> (B, Npad, F)."""
    ncell = reso * reso
    cell = cells.long() >> level_shift(reso, finest)
    valid = (cells >= 0) & (cell < ncell)
    per_cell = plane_to_morton(g_plane / counts.clamp_min(1).to(g_plane.dtype)[..., None])
    idx = torch.where(valid, cell, torch.zeros_like(cell))
    dv = torch.gather(per_cell, 1, idx[..., None].expand(*idx.shape, g_plane.shape[-1]))
    return torch.where(valid[..., None], dv, torch.zeros_like(dv))


def scatter_mean_plane_v3_plain(values, cells, tile_offsets, reso: int, finest: int):
    """K14's function: K12's, from the finest tile offsets."""
    level = level_shift(reso, finest) // 2
    return _tile_mean_plain(values, cells, tile_offsets[:, ::4 ** level], reso,
                            2 * level, False)


# --- kernels ----------------------------------------------------------------------


def _forward_only(values, name: str) -> None:
    if torch.is_grad_enabled() and values.requires_grad:
        raise RuntimeError(f"{name} is forward-only: the JAX kernel it ports has no "
                           "vjp (train on the 'fused' or 'fused2' layout)")


def _check_tiles(name, values, cells, toff, reso: int, step: int) -> None:
    """Raise unless the arguments fit a launch over ``reso``'s 256-cell tiles,
    tile t of entry b spanning rows [toff[b, t*step], toff[b, (t+1)*step])."""
    dev = values.device
    b, n, f = values.shape
    if (reso * reso) % TILE_CELLS:
        raise ValueError(f"{name}: reso**2 = {reso * reso} is not a multiple of "
                         f"{TILE_CELLS}")
    tiles = reso * reso // TILE_CELLS
    runtime.require(values, "values", value_dtype("values", values), (b, n, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(toff, "tile offsets", torch.int32, (b, toff.shape[1]), dev)
    if toff.shape[1] < tiles * step + 1:
        raise ValueError(f"{name}: {toff.shape[1]} tile offsets, need {tiles * step + 1}")


def _scatter_runs(name, values, cells, toff, reso: int, shift: int, step: int,
                  morton: bool = False, with_counts: bool = False):
    """Launch ``t2h_scatter_runs`` with the tile check (K11-K14): a row adds
    into its cell ``cells >> shift`` when it lies in the rows
    [toff[b, t*step], toff[b, (t+1)*step]) of the cell's tile t. Returns the
    row-major plane (B, reso, reso, F), or with ``morton`` the Morton-ordered
    cell vector (B, reso**2, F); with ``with_counts`` (row-major only) also
    the (B, reso, reso) int32 counts. The output in the values' dtype (f32 or
    bf16: ``t2h_scatter_runs_bf16``), counted under ``name`` or
    ``<name>_bf16``."""
    dev, dt = values.device, values.dtype
    b, n, f = values.shape
    _check_tiles(name, values, cells, toff, reso, step)
    cells_shape = (b, reso * reso) if morton else (b, reso, reso)
    out = torch.empty(cells_shape + (f,), device=dev, dtype=dt)
    flags = torch.empty(cells_shape, device=dev, dtype=torch.uint8)
    counts = torch.empty(cells_shape, device=dev, dtype=torch.int32) if with_counts else None
    err = runtime.entry("scatter_runs", dt)(
        values.data_ptr(), cells.data_ptr(), 0, toff.data_ptr(), out.data_ptr(),
        0 if counts is None else counts.data_ptr(), flags.data_ptr(), b, n, f, reso, shift,
        toff.shape[1], step, int(morton), runtime.stream_ptr(dev))
    runtime.check(err, name)
    runtime.launched(name, dt)
    return (out, counts) if with_counts else out


def scatter_mean_plane(values, cells, offsets, reso: int):
    """K11: Morton-sorted rows -> (B, reso, reso, C) row-major plane.

    Args:
        values: (B, N, C) f32 or bf16, Morton-cell-sorted.
        cells: (B, N) int32 Morton ids at ``reso`` (pads >= reso**2).
        offsets: (B, reso**2 + 1) int32 per-cell segment offsets.
    Forward-only.
    """
    _forward_only(values, "scatter_mean_plane")
    if runtime.on_cpu(values):
        return scatter_mean_plane_plain(values, cells, offsets, reso)
    return _scatter_runs("scatter_mean_plane", values, cells, offsets, reso, 0, TILE_CELLS)


def scatter_mean(values, cells, offsets, reso: int):
    """K13: as :func:`scatter_mean_plane`, but the Morton-ordered cell vector
    (B, reso**2, C). Forward-only."""
    _forward_only(values, "scatter_mean")
    if runtime.on_cpu(values):
        return scatter_mean_plain(values, cells, offsets, reso)
    return _scatter_runs("scatter_mean", values, cells, offsets, reso, 0, TILE_CELLS,
                         morton=True)


def aligned_scatter_mean_plane(values, cells, tile_offsets, reso: int, finest: int,
                               with_counts: bool = False):
    """K12: aligned-layout rows -> (B, reso, reso, F) row-major plane.

    Args:
        values: (B, Npad, F) f32 or bf16.
        cells: (B, Npad) int32 finest Morton ids (``PAD_CELL_SENTINEL`` on pads).
        tile_offsets: (B, reso**2 / 256 + 1) int32 row offsets at this
            resolution (every 4**level-th finest tile offset).
        finest: the resolution of ``cells``.
        with_counts: also return the (B, reso, reso) int32 counts (written
            by the same launch), which the backward reads.
    Not differentiable itself: the model calls it through
    ``ops.fused.tile_scatter_mean``.
    """
    if runtime.on_cpu(values):
        return aligned_scatter_mean_plane_plain(values, cells, tile_offsets, reso, finest,
                                                with_counts)
    return _scatter_runs("aligned_scatter_mean_plane", values, cells, tile_offsets, reso,
                         level_shift(reso, finest), 1, with_counts=with_counts)


def aligned_scatter_mean_plane_bwd(g_plane, cells, counts, reso: int,
                                   finest: int) -> torch.Tensor:
    """K12's backward: the arguments and return of
    :func:`aligned_scatter_mean_plane_bwd_plain`; on a card one launch of K2
    alone (``t2h_pool_gather`` at the level's shift, no mask; bf16:
    ``t2h_pool_gather_cut_bf16``, the counts cut to bf16), all tensors
    contiguous, g_plane f32 or bf16, cells and counts int32. Counted in
    ``LAUNCHES['aligned_scatter_mean_plane_bwd']`` besides K2's own
    ``pool_gather`` (each ``_bf16`` in bf16)."""
    if runtime.on_cpu(g_plane):
        return aligned_scatter_mean_plane_bwd_plain(g_plane, cells, counts, reso, finest)
    dev, dt = g_plane.device, value_dtype("g_plane", g_plane)
    b, r, _, f = g_plane.shape
    n = cells.shape[-1]
    if r != reso:
        raise ValueError(f"g_plane resolution {r} != reso {reso}")
    runtime.require(g_plane, "g_plane", dt, (b, r, r, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(counts, "counts", torch.int32, (b, r, r), dev)
    out = torch.empty((b, n, f), device=dev, dtype=dt)
    k2 = (runtime.library().t2h_pool_gather if dt == torch.float32
          else runtime.library().t2h_pool_gather_cut_bf16)
    err = k2(g_plane.data_ptr(), cells.data_ptr(), 0, counts.data_ptr(), out.data_ptr(), b, n,
             f, reso, level_shift(reso, finest), runtime.stream_ptr(dev))
    runtime.check(err, "pool_gather")
    runtime.launched("pool_gather", dt)
    runtime.launched("aligned_scatter_mean_plane_bwd", dt)
    return out


def scatter_mean_plane_v3(values, cells, tile_offsets, reso: int, finest: int):
    """K14: K12's function from the FINEST tile offsets (B, finest**2 / 256 + 1),
    coarsened inside (every 4**level-th). Forward-only."""
    _forward_only(values, "scatter_mean_plane_v3")
    if runtime.on_cpu(values):
        return scatter_mean_plane_v3_plain(values, cells, tile_offsets, reso, finest)
    shift = level_shift(reso, finest)
    return _scatter_runs("scatter_mean_plane_v3", values, cells, tile_offsets, reso, shift,
                         4 ** (shift // 2))
