"""Differentiable wrappers over the aligned Morton tile kernels of
``sorted_impl='fused'``: K9 (sample), K10 (local pooling), K12 (scatter-mean).

Counterpart of ``tomosar2height_tpu/ops/pallas/fused.py``. As there, the
forward is the kernel and the backward is the autograd of the plain
composition (grid_sample, the segment ops), recomputed in the backward by
:class:`~tomosar2height_tpu_torch.ops.cuda.conv_kernel.PlainVjp`; no backward
kernel. For max pooling the subgradient therefore follows the plain
``segment_max`` (ties share it evenly, as JAX's segment_max vjp does).

The JAX module's ``make_aux``/``chunk_cells`` reshape coordinates and ids
into the TPU kernels' 128-lane rows; the kernels here read the (B, N, 2)
coordinates and (B, N) ids as they are, so these functions take those.
Layout contract: ``host_morton_bucket_aligned`` with ``tile_cells=256``.
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as pk
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk
from tomosar2height_tpu_torch.ops.cuda.conv_kernel import PlainVjp
from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d
from tomosar2height_tpu_torch.ops.scatter import segment_max, segment_mean
from tomosar2height_tpu_torch.ops.sorted_scatter import gather_cells_sorted


def _masked(mask, out):
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def _gather_plain(plane, xy, mask, tile_offsets):
    return _masked(mask, grid_sample_2d(plane, xy))


def tile_gather(plane, xy, mask, tile_offsets, reso: int) -> torch.Tensor:
    """Bilinear-sample the (B, R, R, F) ``plane`` at aligned (B, N, 2) ``xy``;
    masked rows are 0. K9 forward; differentiable in ``plane``.
    ``tile_offsets``: (B, R*R/256 + 1) at this resolution."""
    if plane.shape[1] != reso:
        raise ValueError(f"plane resolution {plane.shape[1]} != reso {reso}")

    def kernel(p, x, m, toff):
        return _masked(m, gk.tile_gather(p, x, toff))

    return PlainVjp.apply(kernel, _gather_plain, plane, xy, mask,
                          tile_offsets.contiguous())


def tile_pool(values, cells, tile_offsets, mask, reso: int, kind: str) -> torch.Tensor:
    """Per-cell ``kind`` reduce + per-row gather-back (pool_local, reference
    pointnet.py:92-99) on the aligned layout; masked rows are 0. K10 forward;
    differentiable in ``values``. ``cells``: finest ids at ``reso``."""
    if kind not in ("max", "mean"):
        raise ValueError(f"kind must be 'max' or 'mean', got {kind!r}")

    def kernel(v, c, toff, m):
        return _masked(m, pk.tile_pool(v, c, toff, kind))

    def plain(v, c, toff, m):
        reduce = segment_max if kind == "max" else segment_mean
        return _masked(m, gather_cells_sorted(reduce(v, c, reso * reso, m), c))

    return PlainVjp.apply(kernel, plain, values, cells, tile_offsets, mask)


def tile_scatter_mean(values, cells, tile_offsets, reso: int, finest: int) -> torch.Tensor:
    """Aligned Morton scatter-mean -> (B, reso, reso, F) NHWC plane; pad rows
    (sentinel ids) add nothing and get a zero gradient. K12 forward;
    differentiable in ``values``. ``tile_offsets``: at ``reso``; ``cells``:
    finest ids at ``finest``."""
    return PlainVjp.apply(
        lambda v, c, t: sk.aligned_scatter_mean_plane(v, c, t, reso, finest),
        lambda v, c, t: sk.aligned_scatter_mean_plane_plain(v, c, t, reso, finest),
        values, cells, tile_offsets.contiguous())
