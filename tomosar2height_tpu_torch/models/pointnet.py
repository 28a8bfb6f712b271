"""LocalPoolPointnet: per-point ResNet-FC MLP with interleaved local pooling,
then a scatter to a feature plane refined by the ALTO U-Net.

Counterpart of ``tomosar2height_tpu/models/pointnet.py`` (reference
encoder/pointnet.py:13-111). Its paths, chosen by ``sorted_impl`` when the
loader ships Morton-sorted rows (``offsets`` given), else unsorted:

- ``fused2`` on the aligned layout with 1024-cell tiles: pooling is ``pool2``
  (K1+K2), the plane ``scatter_plane2`` (K3), the U-Net's round trips
  ``fused_level`` (K4);
- ``fused`` on the aligned layout with 256-cell tiles: pooling is
  ``tile_pool`` (K10), the plane ``tile_scatter_mean`` (K12), the U-Net
  samples with ``tile_gather`` (K9) and scatters with K12;
- ``pallas`` and ``cumsum`` on the plain sorted layout (per-cell offsets, pads
  at reso**2): max pooling by ``segment_max``, mean pooling and the planes by
  the tile kernels K13/K11 (``pallas``) or cumulative sums (``cumsum``);
- the unsorted plain path: cell ids from the coordinates and plain torch
  segment ops.

``dtype`` is the compute dtype (``blocks`` module docstring). Every path
runs in bf16: the kernels of ``fused2`` (K1-K5) and of ``fused``/``pallas``
(K9-K13) have bf16 instances, each with its JAX kernel's rounding points;
``segment_max`` is exact in bf16, and the cumulative sums of ``cumsum`` run
in float64 and round each cell's sum to bf16 once, its counts cast to bf16
and the mean divided in bf16 (JAX ops/sorted_scatter.py:301-315).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tomosar2height_tpu_torch.models.alto import AltoUNet
from tomosar2height_tpu_torch.models.blocks import Dense, ResnetBlockFC
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import pool2, scatter_plane2
from tomosar2height_tpu_torch.ops.fused import tile_pool, tile_scatter_mean
from tomosar2height_tpu_torch.ops.scatter import (
    cell_index,
    pool_local_max,
    pool_local_mean,
    segment_max,
    segment_mean,
)
from tomosar2height_tpu_torch.ops.sorted_scatter import (
    PAD_CELL_SENTINEL,
    gather_sorted_rows,
    morton_cells_device,
    scatter_mean_morton,
    scatter_mean_plane_morton,
)

SORTED_IMPLS = ("cumsum", "pallas", "fused", "fused2")


class LocalPoolPointnet(nn.Module):
    """Point encoder producing {'xy': (B, R, R, feature_dim)}."""

    N_BLOCKS = 5

    def __init__(self, feature_dim: int = 32, hidden_dim: int = 32,
                 scatter_type: str = "max", unet_type: str = "alto",
                 unet_kwargs: Optional[dict] = None, plane_resolution: int = 256,
                 sorted_impl: str = "cumsum", dtype: torch.dtype = torch.float32):
        super().__init__()
        if scatter_type not in ("max", "mean"):
            raise ValueError(f"Invalid scatter type: {scatter_type}")
        if sorted_impl not in SORTED_IMPLS:
            raise ValueError(f"sorted_impl={sorted_impl!r}: one of {SORTED_IMPLS}")
        if unet_type != "alto":
            raise NotImplementedError(
                f"unet_type={unet_type!r}: only the ALTO U-Net is ported "
                "for the point plane (ROADMAP: alternates)")
        self.reso = plane_resolution
        self.scatter_type = scatter_type
        self.sorted_impl = sorted_impl
        self.dtype = dtype
        self.fc_pos = Dense(3, 2 * hidden_dim, dtype=dtype)
        for i in range(self.N_BLOCKS):
            self.add_module(f"block{i}", ResnetBlockFC(2 * hidden_dim, hidden_dim, dtype))
        self.fc_c = Dense(hidden_dim, feature_dim, dtype=dtype)
        self.unet = AltoUNet(feature_dim, feature_dim, feature_dim,
                             **dict(unet_kwargs or {}), dtype=dtype)

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                cells: Optional[torch.Tensor] = None,
                offsets: Optional[torch.Tensor] = None) -> dict:
        """
        Args:
            points: (B, N, 3) normalized to [0, 1].
            mask: (B, N) bool validity.
            cells: (B, N) int32 finest Morton ids of the sorted layout; when
                None but ``offsets`` is given they are recomputed from the
                points (bit-exact with the loader's).
            offsets: the sorted layout's offsets, whose presence selects the
                ``sorted_impl`` path: (B, T + 1) tile offsets of the aligned
                layout (``fused``/``fused2``), else (B, R*R + 1) per-cell
                offsets.
        """
        reso = self.reso
        b = points.shape[0]
        xy = points[..., :2]
        impl = self.sorted_impl if offsets is not None else None
        if impl is not None:
            if cells is None:
                # pads: the sentinel on the aligned layouts, reso**2 on the plain
                # sorted one (pointnet.py:83-86)
                pad = int(PAD_CELL_SENTINEL) if impl in ("fused", "fused2") else reso * reso
                cells = morton_cells_device(points, mask, reso, pad)
            cells = cells.to(torch.int32).contiguous()
        if impl == "fused2":
            def pool_fn(values):
                return pool2(values, cells, mask, reso, self.scatter_type)
        elif impl == "fused":
            def pool_fn(values):
                return tile_pool(values, cells, offsets, mask, reso, self.scatter_type)
        elif impl is not None:
            def pool_fn(values):
                if self.scatter_type == "max":
                    pooled = segment_max(values, cells, reso * reso, mask)
                else:
                    pooled = scatter_mean_morton(values, offsets, cells, reso, impl)
                return gather_sorted_rows(pooled, cells, offsets)
        else:
            index = cell_index(xy, reso)
            pool = pool_local_max if self.scatter_type == "max" else pool_local_mean

            def pool_fn(values):
                return pool(values, index, reso, mask)

        net = self.block0(self.fc_pos(points))
        for i in range(1, self.N_BLOCKS):
            net = getattr(self, f"block{i}")(torch.cat([net, pool_fn(net)], dim=-1))
        net = self.fc_c(torch.relu(net))

        if impl == "fused2":
            plane, _ = scatter_plane2(net, cells, mask, reso)
            buckets = {"impl": impl, "cells": cells}
        elif impl == "fused":
            plane = tile_scatter_mean(net, cells, offsets, reso, reso)
            buckets = {"impl": impl, "cells": cells, "tile_offsets": offsets}
        elif impl is not None:
            plane = scatter_mean_plane_morton(net, offsets, cells, reso, impl)
            buckets = {"impl": impl, "cells": cells, "offsets": offsets}
        else:
            plane = segment_mean(net, index, reso * reso, mask)
            plane = plane.reshape(b, reso, reso, net.shape[-1])
            buckets = None
        return {"xy": self.unet(points, plane, net, mask, buckets)}
