"""Differentiable wrappers over the aligned Morton tile kernels of
``sorted_impl='fused'``: K9 (sample), K10 (local pooling), K12 (scatter-mean).

Counterpart of ``tomosar2height_tpu/ops/pallas/fused.py``: each function is a
``torch.autograd.Function`` whose forward is the kernel and whose backward
is the JAX custom_vjp's rule, on a kernel that adds in a fixed order, so a
training step on this layout is bit-equal run to run:

- K9 ``tile_gather``: grid_sample's transpose of the masked cotangent into
  the plane (``_tile_gather_bwd``, fused.py:65-74) on K5's d_plane pass
  (:func:`~tomosar2height_tpu_torch.ops.cuda.gather_kernel.tile_gather_bwd`);
- K10 ``tile_pool``: the vjp of ``segment_max``/``segment_mean`` and the
  gather-back (``_tile_pool_bwd``, fused.py:118-124; max's ties split the
  cell's cotangent evenly) on the run kernel
  (:func:`~tomosar2height_tpu_torch.ops.cuda.pool_kernel.tile_pool_bwd`);
- K12 ``tile_scatter_mean``: each row's cell cotangent over the cell's count
  (``_tile_scatter_bwd``, fused.py:149-173) on K2 alone at the level's shift
  (:func:`~tomosar2height_tpu_torch.ops.cuda.scatter_kernel.aligned_scatter_mean_plane_bwd`),
  with the counts the forward's run scatter wrote.

:func:`sorted_sample` is the sample of the sorted layouts that K9 does not
take (``cumsum``, ``pallas``, ``fused`` below 32^2): ``grid_sample_2d``
forward, the same d_plane pass backward.

In bf16 (the model's bf16 dtype) each function takes and returns bf16 and
each kernel its bf16 instance, both ways. Two sample rules meet here: K9's
output is bf16 (its weights cut to bf16) and so is its cotangent, whose
d_plane pass takes the transpose of the cut weights; ``sorted_sample``'s
output is float32 (the f32 weights promote a bf16 plane, JAX
ops/sampling.py:28-46), and so is its cotangent, whose d_plane pass sums
with the uncut weights in f32 and rounds each pixel to bf16 once, as JAX's
vjp rounds its f32 d_plane to the plane's dtype.

On CPU tensors the wrappers run the plain versions both ways. The JAX
module's ``make_aux``/``chunk_cells`` reshape coordinates and ids into the
TPU kernels' 128-lane rows; the kernels here read the (B, N, 2) coordinates
and (B, N) ids as they are, so these functions take those. Layout contract:
``host_morton_bucket_aligned`` with ``tile_cells=256``.
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as pk
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk
from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d


def _masked(mask, out):
    return torch.where(mask[..., None], out, torch.zeros_like(out))


class _SortedSample(torch.autograd.Function):
    """The bilinear sample on a Morton-sorted layout: K9 with ``tile_offsets``
    (masked rows 0), else ``grid_sample_2d``. Backward: K5's d_plane pass
    either way (K9's as ``tile_gather_bwd``), which needs each finest cell's
    valid rows contiguous, as every sorted layout has them."""

    @staticmethod
    def forward(ctx, plane, xy, mask, cells, tile_offsets, reso: int, finest: int):
        if tile_offsets is None:
            out = grid_sample_2d(plane, xy)
        else:
            out = _masked(mask, gk.tile_gather(plane, xy, tile_offsets))
        ctx.save_for_backward(xy, mask, cells)
        ctx.reso, ctx.finest, ctx.k9 = reso, finest, tile_offsets is not None
        ctx.plane_dtype = plane.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        xy, mask, cells = ctx.saved_tensors
        args = (g.contiguous(), xy, cells, mask, ctx.reso, ctx.finest)
        if ctx.k9:
            d_plane = gk.tile_gather_bwd(*args)
        else:
            d_plane = lk.level_d_plane(*args, out_dtype=ctx.plane_dtype)
        return d_plane, None, None, None, None, None, None


class _TilePool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, cells, tile_offsets, mask, kind: str):
        out = _masked(mask, pk.tile_pool(values, cells, tile_offsets, kind))
        ctx.save_for_backward(values, cells, tile_offsets, mask, out)
        ctx.kind = kind
        return out

    @staticmethod
    def backward(ctx, g):
        values, cells, tile_offsets, mask, out = ctx.saved_tensors
        dv = pk.tile_pool_bwd(_masked(mask, g).contiguous(), values, out, cells,
                              tile_offsets, ctx.kind)
        return dv, None, None, None, None


class _TileScatterMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, cells, tile_offsets, reso: int, finest: int):
        plane, counts = sk.aligned_scatter_mean_plane(values, cells, tile_offsets, reso,
                                                      finest, with_counts=True)
        ctx.save_for_backward(cells, counts)
        ctx.reso, ctx.finest = reso, finest
        return plane

    @staticmethod
    def backward(ctx, g_plane):
        cells, counts = ctx.saved_tensors
        dv = sk.aligned_scatter_mean_plane_bwd(g_plane.contiguous(), cells, counts, ctx.reso,
                                               ctx.finest)
        return dv, None, None, None, None


def tile_gather(plane, xy, mask, cells, tile_offsets, reso: int, finest: int) -> torch.Tensor:
    """Bilinear-sample the (B, R, R, F) ``plane`` at aligned (B, N, 2) ``xy``;
    masked rows are 0. K9 forward; differentiable in ``plane`` (backward: K5's
    d_plane pass, which reads the finest ids ``cells`` at ``finest``).
    ``tile_offsets``: (B, R*R/256 + 1) at this resolution."""
    if plane.shape[1] != reso:
        raise ValueError(f"plane resolution {plane.shape[1]} != reso {reso}")
    return _SortedSample.apply(plane, xy, mask, cells, tile_offsets.contiguous(), reso,
                               finest)


def sorted_sample(plane, xy, mask, cells, finest: int) -> torch.Tensor:
    """``grid_sample_2d`` of the (B, R, R, F) ``plane`` at (B, N, 2) ``xy`` on
    a Morton-sorted layout without K9 (``cumsum``/``pallas``, and ``fused``
    below 32^2), differentiable in ``plane`` through K5's d_plane pass: a
    fixed-order sum, so the step is bit-equal run to run. ``cells``: finest
    ids at ``finest``; the masked rows' cotangent is ignored (it is 0: no
    scatter reads them)."""
    return _SortedSample.apply(plane, xy, mask, cells, None, plane.shape[1], finest)


def tile_pool(values, cells, tile_offsets, mask, reso: int, kind: str) -> torch.Tensor:
    """Per-cell ``kind`` reduce + per-row gather-back (pool_local, reference
    pointnet.py:92-99) on the aligned layout; masked rows are 0. K10 forward;
    differentiable in ``values``. ``cells``: finest ids at ``reso``, whose
    256-cell tiles ``tile_offsets`` delimit."""
    if kind not in ("max", "mean"):
        raise ValueError(f"kind must be 'max' or 'mean', got {kind!r}")
    if (tile_offsets.shape[1] - 1) * 256 != reso * reso:
        raise ValueError(f"{tile_offsets.shape[1] - 1} tiles of 256 cells do not cover "
                         f"{reso}^2")
    return _TilePool.apply(values, cells, tile_offsets, mask, kind)


def tile_scatter_mean(values, cells, tile_offsets, reso: int, finest: int) -> torch.Tensor:
    """Aligned Morton scatter-mean -> (B, reso, reso, F) NHWC plane; pad rows
    (sentinel ids) add nothing and get a zero gradient. K12 forward;
    differentiable in ``values``. ``tile_offsets``: at ``reso``; ``cells``:
    finest ids at ``finest``."""
    return _TileScatterMean.apply(values, cells, tile_offsets.contiguous(), reso, finest)
