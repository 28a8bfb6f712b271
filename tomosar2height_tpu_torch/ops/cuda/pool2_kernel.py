"""Local pooling (reduce + gather-back) and the encoder's plane scatter on the
Morton-aligned layout.

Counterpart of ``tomosar2height_tpu/ops/pallas/pool2_kernel.py``. CUDA kernels
(``csrc/pool2.cu``) replace its three Pallas kernels:

- K1 + K2 on pool2's path, one kernel (``pool_runs``): ``_reduce_kernel``
  (pool2_kernel.py:46) then ``_gather_kernel`` (:133), as
  ``_chunkgrid_pool_jit`` (:221) runs them. Each valid row gets the max, mean
  or sum of the valid rows of its cell, pad rows 0, in one atomic-free pass
  over the sorted runs (:func:`pool2_fwd`, :func:`pool2_bwd`). The same
  kernel, with the tile check in place of the mask, serves K10 in
  ``pool_kernel.py``.
- K2 alone (``pool_gather``) for ``scatter_plane2``'s backward: each valid
  row reads a row-major plane at its cell (:func:`scatter_plane2_bwd`); a
  warp takes a 32-row span, as ``pool_runs`` does, and reads each run's cell
  once (rows in any order: unsorted ones only read more).
- K3 :func:`scatter_plane2` <- ``_scatter_plane_kernel`` (pool2_kernel.py:263):
  masked scatter-mean into a row-major NHWC plane, plus per-cell counts, on
  the same runs (``scatter_runs``, :func:`scatter_runs_masked`, which also
  serves K4's plane in ``level_kernel.py`` and K11-K14 in
  ``scatter_kernel.py``): each run's row-order mean and count written to its
  cell once, the empty cells (marked first) zeroed in the same launch; no
  atomics.

Each takes float32 or bfloat16 values (the model's ``model.dtype``), its
outputs in the values' dtype, and launches its instance for that dtype
(``t2h_*`` or ``t2h_*_bf16``; counted under ``<name>`` or ``<name>_bf16``).
bf16 follows the JAX kernels' rule (pool2_kernel.py:88-117,148-158,292-334):
bf16 values summed (or maxed) in f32 in the same run order, each output
rounded to bf16 once; the plain versions do the same in torch (an f32
reduction rounded once), so a bf16 kernel and its plain version differ only
by the f32 summation order.

They read only the finest Morton cell ids and the mask: the TPU's chunk
metadata (ct/pt/tmask) served its sequential grid and has no use here. What
bounds them on the H100 and how the design answers it is noted in the CUDA
source. A CPU tensor takes the plain torch version (``*_plain``), a CUDA
tensor the kernel; there is no fallback between the two.

**Contract of the run kernels** (``pool_runs``, ``scatter_runs``): in each
batch entry the rows that hold one cell id, and so the cell's valid rows,
are contiguous (the mask may clear rows among them), as on the aligned
layout (``ops/sorted_scatter.py``, :func:`host_morton_bucket_aligned`:
Morton-sorted rows, pads only at tile ends). A run is a maximal range of
rows with one in-range cell id; a cell split into two runs would pool as two
cells (or, scattered, keep one run's mean), unchecked. The plain versions
(:func:`pool2_plain`, :func:`pool2_bwd_plain`, :func:`scatter_plane2_plain`)
take any order and are the oracle.

:func:`pool2` and :func:`scatter_plane2` are differentiable in ``values``
(``torch.autograd.Function``s); their backwards follow the JAX custom_vjps
(pool2_kernel.py:424-453, :492-517):

- mean pool: the run mean of the masked cotangent;
- max pool: ``dv = where(values == out, run_sum(g), 0)``: every tied point
  gets the whole cell sum (the tie gate is fused into the kernel);
- scatter_plane2: ``dv[i] = g_plane[cell_i] / max(count, 1)`` on valid rows,
  one K2 launch reading the row-major plane. It divides, as the plain
  version does (bit-equal to it); JAX multiplies by ``1 / max(count, 1)``
  (pool2_kernel.py:448), within one rounding of that. In bf16 the f32
  quotient is rounded to bf16 once, then gathered (:424-453).

In bf16 the max backward's tie gate compares the bf16 values (exact in f32,
as :514 compares them) and each gradient is rounded once, as JAX's.
"""

from __future__ import annotations

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


def acc_dtype(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype its sums are taken in: float32 for bfloat16 values (the
    JAX kernels' f32 accumulators), else its own (float32, or the float64
    the step tests run in)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _valid_index(cells: torch.Tensor, mask: torch.Tensor, ncell: int):
    valid = mask & (cells >= 0) & (cells < ncell)
    return torch.where(valid, cells, torch.zeros_like(cells)), valid


# --- plain versions ---------------------------------------------------------------


def pool_reduce_plain(values, cells, mask, ncell: int, kind: str) -> torch.Tensor:
    """(B, N, F) values -> (B, ncell, F) per-cell max/mean/sum in Morton order,
    reduced in float32 and rounded to the values' dtype once."""
    idx, valid = _valid_index(cells, mask, ncell)
    reduce = {"max": segment_max, "sum": segment_sum, "mean": segment_mean}[kind]
    return reduce(acc_dtype(values), idx, ncell, valid).to(values.dtype)


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
    """Masked scatter-mean -> (plane (B, reso, reso, F) in the values' dtype,
    the f32 mean rounded once; counts (B, reso, reso) int32)."""
    ncell = reso * reso
    idx, valid = _valid_index(cells, mask, ncell)
    counts = segment_counts(idx, ncell, valid)
    vec = segment_mean(acc_dtype(values), idx, ncell, valid, counts=counts).to(values.dtype)
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
    reads g_plane at its cell divided by max(count, 1) (the f32 quotient in
    g_plane's dtype); 0 elsewhere."""
    g = acc_dtype(g_plane)
    scaled = (g / counts.clamp_min(1).to(g.dtype)[..., None]).to(g_plane.dtype)
    return pool_gather_plain(plane_to_morton(scaled), cells, mask)


# --- kernels ----------------------------------------------------------------------

VALUE_DTYPES = (torch.float32, torch.bfloat16)
"""The value dtypes the run kernels, K2 and the tile kernels have instances
for."""


def value_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    """x's dtype if the kernels have an instance for it; else raise."""
    if x.dtype not in VALUE_DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype}, expected float32 or bfloat16")
    return x.dtype


def _check_points(values, cells, mask):
    dev = values.device
    b, n, f = values.shape
    runtime.require(values, "values", value_dtype("values", values), (b, n, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    return b, n, f


def _pool_runs(x, cells, mask, reso: int, kind: str, tie=None) -> torch.Tensor:
    """Launch the run kernel on (B, N, F) rows; ``tie`` = (values, out) gates
    a 'sum' by values == out (max pooling's backward)."""
    b, n, f = _check_points(x, cells, mask)
    if tie is not None:
        for name, t in zip(("values", "out"), tie):
            runtime.require(t, name, x.dtype, (b, n, f), x.device)
    out = torch.empty_like(x)
    a, c = (0, 0) if tie is None else (tie[0].data_ptr(), tie[1].data_ptr())
    err = runtime.entry("pool_runs", x.dtype)(
        x.data_ptr(), cells.data_ptr(), mask.data_ptr(), 0, a, c, out.data_ptr(), b, n, f,
        reso * reso, _KINDS[kind], runtime.stream_ptr(x.device))
    runtime.check(err, "pool_runs")
    return out


def pool2_fwd(values, cells, mask, reso: int, kind: str) -> torch.Tensor:
    """K1 + K2: each valid row gets the ``kind`` ('max' | 'mean' | 'sum') of
    the valid rows of its cell, pad rows 0; one launch on the sorted runs
    (the contract above). Counted in ``LAUNCHES['pool2']``."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    if runtime.on_cpu(values):
        return pool2_plain(values, cells, mask, reso, kind)
    out = _pool_runs(values, cells, mask, reso, kind)
    runtime.launched("pool2", values.dtype)
    return out


def pool2_bwd(g, values, out, cells, mask, reso: int, kind: str) -> torch.Tensor:
    """Backward of :func:`pool2`, one launch of the run kernel: the run mean
    of g ('mean'), or the run sum of g where ``values == out`` ('max').
    Counted in ``LAUNCHES['pool2_bwd']``."""
    if runtime.on_cpu(g):
        return pool2_bwd_plain(g, values, out, cells, mask, reso, kind)
    dv = _pool_runs(g, cells, mask, reso, "mean" if kind == "mean" else "sum",
                    None if kind == "mean" else (values, out))
    runtime.launched("pool2_bwd", g.dtype)
    return dv


def scatter_plane2_bwd(g_plane, cells, mask, counts) -> torch.Tensor:
    """Backward of :func:`scatter_plane2`: K2 reading the row-major cotangent
    plane at each valid row's cell, divided by max(count, 1). Counted in
    ``LAUNCHES['scatter_plane2_bwd']`` besides K2's own ``pool_gather``."""
    if runtime.on_cpu(g_plane):
        return scatter_plane2_bwd_plain(g_plane, cells, mask, counts)
    dev, dt = g_plane.device, value_dtype("g_plane", g_plane)
    b, reso, _, f = g_plane.shape
    n = cells.shape[-1]
    runtime.require(g_plane, "g_plane", dt, (b, reso, reso, f), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    runtime.require(counts, "counts", torch.int32, (b, reso, reso), dev)
    out = torch.empty((b, n, f), device=dev, dtype=dt)
    err = runtime.entry("pool_gather", dt)(
        g_plane.data_ptr(), cells.data_ptr(), mask.data_ptr(), counts.data_ptr(),
        out.data_ptr(), b, n, f, reso, 0, runtime.stream_ptr(dev))
    runtime.check(err, "pool_gather")
    runtime.launched("pool_gather", dt)
    runtime.launched("scatter_plane2_bwd", dt)
    return out


class _Pool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, cells, mask, reso: int, kind: str):
        out = pool2_fwd(values, cells, mask, reso, kind)
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
    """Masked pool_local on the aligned layout (:func:`pool2_fwd`, one launch
    of the run kernel); differentiable in ``values`` (backward:
    :func:`pool2_bwd`). Needs the aligned layout's contiguous cells on a card
    (module docstring).

    Args:
        values: (B, N, F) f32 or bf16 point features.
        cells: (B, N) int32 finest Morton ids (PAD_CELL_SENTINEL on pads),
            the rows of each cell, and so its valid rows, contiguous.
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
    out = scatter_runs_masked(values, cells, mask, reso, 0)
    runtime.launched("scatter_plane2", values.dtype)
    return out


def scatter_runs_masked(values, cells, mask, reso: int, shift: int):
    """Launch the run scatter (``t2h_scatter_runs``) with the mask: the masked
    scatter-mean of (B, N, F) ``values`` into cell ``cells >> shift`` of a
    row-major plane -> (plane (B, reso, reso, F), counts (B, reso, reso)
    int32), each cell written once; the plane in the values' dtype (f32 or
    bf16). K3 (shift 0) and K4's plane (``level_kernel``, the level's shift)
    take it; their wrappers count the launch. Each cell's valid rows must be
    one run (the module's contract)."""
    b, n, f = _check_points(values, cells, mask)
    dev = values.device
    plane = torch.empty((b, reso, reso, f), device=dev, dtype=values.dtype)
    counts = torch.empty((b, reso, reso), device=dev, dtype=torch.int32)
    flags = torch.empty((b, reso, reso), device=dev, dtype=torch.uint8)
    err = runtime.entry("scatter_runs", values.dtype)(
        values.data_ptr(), cells.data_ptr(), mask.data_ptr(), 0, plane.data_ptr(),
        counts.data_ptr(), flags.data_ptr(), b, n, f, reso, shift, 0, 0, 0,
        runtime.stream_ptr(dev))
    runtime.check(err, "scatter_runs")
    return plane, counts
