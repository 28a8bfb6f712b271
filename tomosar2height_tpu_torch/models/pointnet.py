"""LocalPoolPointnet: per-point ResNet-FC MLP with interleaved local pooling,
then a scatter to a feature plane refined by the ALTO U-Net.

Counterpart of ``tomosar2height_tpu/models/pointnet.py`` (reference
encoder/pointnet.py:13-111). Two of its paths are ported:

- ``fused2`` on the Morton-aligned layout (cells + tile offsets from the
  loader): pooling is ``pool2`` (kernels K1+K2), the plane is
  ``scatter_plane2`` (K3) and the U-Net's round trips are ``fused_level`` (K4);
- the unsorted plain path (no cells/offsets): cell ids from the coordinates
  and plain torch segment ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tomosar2height_tpu_torch.models.alto import AltoUNet
from tomosar2height_tpu_torch.models.blocks import ResnetBlockFC
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import pool2, scatter_plane2
from tomosar2height_tpu_torch.ops.scatter import (
    cell_index,
    pool_local_max,
    pool_local_mean,
    segment_mean,
)
from tomosar2height_tpu_torch.ops.sorted_scatter import (
    PAD_CELL_SENTINEL,
    morton_cells_device,
)


class LocalPoolPointnet(nn.Module):
    """Point encoder producing {'xy': (B, R, R, feature_dim)}."""

    N_BLOCKS = 5

    def __init__(self, feature_dim: int = 32, hidden_dim: int = 32,
                 scatter_type: str = "max", unet_type: str = "alto",
                 unet_kwargs: Optional[dict] = None, plane_resolution: int = 256,
                 sorted_impl: str = "cumsum"):
        super().__init__()
        if scatter_type not in ("max", "mean"):
            raise ValueError(f"Invalid scatter type: {scatter_type}")
        if unet_type != "alto":
            raise NotImplementedError(
                f"unet_type={unet_type!r}: only the ALTO U-Net is ported "
                "for the point plane (ROADMAP A11)")
        self.reso = plane_resolution
        self.scatter_type = scatter_type
        self.sorted_impl = sorted_impl
        self.fc_pos = nn.Linear(3, 2 * hidden_dim)
        for i in range(self.N_BLOCKS):
            self.add_module(f"block{i}", ResnetBlockFC(2 * hidden_dim, hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, feature_dim)
        self.unet = AltoUNet(feature_dim, feature_dim, feature_dim,
                             **dict(unet_kwargs or {}))

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                cells: Optional[torch.Tensor] = None,
                offsets: Optional[torch.Tensor] = None) -> dict:
        """
        Args:
            points: (B, N, 3) normalized to [0, 1].
            mask: (B, N) bool validity.
            cells: (B, N) int32 finest Morton ids of the aligned layout; when
                None but ``offsets`` is given they are recomputed from the
                points (bit-exact with the loader's).
            offsets: (B, T + 1) tile offsets of the aligned layout; their
                presence selects the sorted path.
        """
        reso = self.reso
        b = points.shape[0]
        xy = points[..., :2]
        if offsets is not None:
            if self.sorted_impl != "fused2":
                raise NotImplementedError(
                    f"sorted_impl={self.sorted_impl!r}: of the sorted paths only "
                    "'fused2' is ported; 'cumsum'/'pallas' wait for ROADMAP A11 "
                    "and 'fused' for ROADMAP B9")
            if cells is None:
                cells = morton_cells_device(points, mask, reso, int(PAD_CELL_SENTINEL))
            cells = cells.to(torch.int32).contiguous()

            def pool_fn(values):
                return pool2(values, cells, mask, reso, self.scatter_type)
        else:
            index = cell_index(xy, reso)
            pool = pool_local_max if self.scatter_type == "max" else pool_local_mean

            def pool_fn(values):
                return pool(values, index, reso, mask)

        net = self.block0(self.fc_pos(points))
        for i in range(1, self.N_BLOCKS):
            net = getattr(self, f"block{i}")(torch.cat([net, pool_fn(net)], dim=-1))
        net = self.fc_c(torch.relu(net))

        if offsets is not None:
            plane, _ = scatter_plane2(net, cells, mask, reso)
            buckets = {"impl": "fused2", "cells": cells}
        else:
            plane = segment_mean(net, index, reso * reso, mask)
            plane = plane.reshape(b, reso, reso, net.shape[-1])
            buckets = None
        return {"xy": self.unet(points, plane, net, mask, buckets)}
