"""ALTO dual-topology U-Net: a grid U-Net where every level round-trips
grid <-> points. Counterpart of ``tomosar2height_tpu/models/alto.py``
(reference encoder/alto.py).

Per Down/Up level: two 3x3 convs (ReLU), a 1x1 (or 2x2 transpose) residual
from the previous level's post-conv plane, then the round trip: bilinear
sample at the points, ``fc_comm`` MLP plus the ``fc_c`` skip from the
previous level's point features, scatter-mean back into the plane.

On the ``fused2`` layout (Morton-aligned points, ``cache['impl'] == 'fused2'``)
a round trip at resolution >= 32 is ONE kernel call
(``ops/cuda/level_kernel.fused_level``); below 32 (the bottom level of a
depth-6 U-Net) the sample and the scatter-mean are dense products with the
level's bilinear and cell matrices (``bilinear_matrix``, ``cell_matrix``),
which add in a fixed order both ways, as the kernels do. Otherwise a round
trip is composed: the sample
(K9 ``tile_gather`` on the ``fused`` layout at resolution >= 32, else
``grid_sample_2d``), the MLPs, and the scatter-mean (K12 on ``fused``; K11 or
cumulative sums over the coarsened per-cell offsets on ``pallas``/``cumsum``;
plain segment ops otherwise). Every path reads the same ``fc_comm``/``fc_c``
parameters. Under ``fused_convs`` each
level's conv pair is one K7 call (``ops/cuda/convpair_kernel.conv_pair``). Planes are NCHW-logical in
``channels_last`` memory; the public interface is NHWC. Every layer computes
in ``dtype``; the sample of a bf16 plane comes back float32 (its f32
weights promote it, JAX ops/sampling.py:45-60) and ``fc_comm`` casts it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from tomosar2height_tpu_torch.models.blocks import (
    MLP2,
    Conv3x3,
    Dense,
    conv1x1,
    fusable,
    fused_pair,
    max_pool_2x2,
    upconv2x2,
)
from tomosar2height_tpu_torch.ops.cuda.level_kernel import fused_level, level_shift
from tomosar2height_tpu_torch.ops.fused import sorted_sample, tile_gather, tile_scatter_mean
from tomosar2height_tpu_torch.ops.sampling import bilinear_matrix, grid_sample_2d
from tomosar2height_tpu_torch.ops.scatter import (
    cell_index,
    cell_matrix,
    segment_counts,
    segment_mean,
)
from tomosar2height_tpu_torch.ops.sorted_scatter import (
    coarsen_offsets,
    coarsen_tile_offsets,
    scatter_mean_plane_morton,
)


def _scatter_plane(xy, c, reso, mask, cache) -> torch.Tensor:
    """scatter_mean of point features into a (B, C, reso, reso) plane
    (reference alto.py:76-88). Sorted layouts reuse the finest sort: offsets
    every 4**level-th, Morton ids shifted by 2*level (alto.py:47-73); the
    plain path caches cell ids and counts per resolution."""
    impl = cache.get("impl")
    if impl in ("fused", "pallas", "cumsum"):
        shift = level_shift(reso, cache["finest"])
        if impl == "fused":
            toff = coarsen_tile_offsets(cache["tile_offsets"], shift // 2)
            plane = tile_scatter_mean(c.contiguous(), cache["cells"], toff, reso,
                                      cache["finest"])
        else:
            plane = scatter_mean_plane_morton(
                c, coarsen_offsets(cache["offsets"], shift // 2), cache["cells"] >> shift,
                reso, impl)
        return plane.permute(0, 3, 1, 2)
    idx = cache.get(reso)
    if idx is None:
        idx = cache[reso] = cell_index(xy, reso)
    counts = cache.get(("counts", reso))
    if counts is None:
        counts = cache[("counts", reso)] = segment_counts(idx, reso * reso, mask)
    plane = segment_mean(c, idx, reso * reso, mask, counts=counts)
    b, _, f = c.shape
    return plane.reshape(b, reso, reso, f).permute(0, 3, 1, 2)


def _sample_plane(x, xy, mask, cache) -> torch.Tensor:
    """Bilinear sample of the NCHW plane at the points (reference
    alto.py:90-95): K9 on the ``fused`` layout at resolution >= 32
    (alto.py:91-105); on the other sorted layouts (and ``fused`` below 32)
    ``sorted_sample``: ``grid_sample_2d`` whose backward is K5's d_plane
    pass, as K9's is, so that they train bit-equal run to run; on the
    unsorted plain path ``grid_sample_2d``."""
    plane = x.permute(0, 2, 3, 1)
    reso = plane.shape[1]
    impl = cache.get("impl")
    if impl == "fused" and reso >= 32:
        toff = coarsen_tile_offsets(cache["tile_offsets"],
                                    level_shift(reso, cache["finest"]) // 2)
        return tile_gather(plane.contiguous(), cache["xy"], mask, cache["cells"], toff, reso,
                           cache["finest"])
    if impl is not None:
        return sorted_sample(plane, cache["xy"], mask, cache["cells"], cache["finest"])
    return grid_sample_2d(plane, xy)


def _round_trip(level: nn.Module, x, xy, c_last, mask, cache):
    """Sample -> fc_comm + fc_c(c_last) -> scatter-mean; returns (plane NCHW, c)."""
    reso = x.shape[-1]
    if cache.get("impl") == "fused2" and reso >= 32:
        fc_in, fc_out, fc_c = level.fc_comm.fc_in, level.fc_comm.fc_out, level.fc_c
        weights = (fc_in.weight.t().contiguous(), fc_in.bias,
                   fc_out.weight.t().contiguous(), fc_out.bias,
                   fc_c.weight.t().contiguous(), fc_c.bias)
        plane = x.permute(0, 2, 3, 1).contiguous()
        plane_out, c, _ = fused_level(plane, c_last.contiguous(), weights, cache["xy"],
                                      cache["cells"], mask, reso, cache["finest"])
        return plane_out.permute(0, 3, 1, 2), c
    if cache.get("impl") == "fused2":
        # no atomics below 32 either: the plain segment ops add with them
        mats = cache.get(("dense", reso))
        if mats is None:
            cells = cell_matrix(xy, reso, mask, x.dtype)
            mats = cache[("dense", reso)] = (bilinear_matrix(xy, reso, reso).to(x.dtype),
                                             cells.transpose(1, 2),
                                             cells.sum(1)[..., None].clamp_min(1.0))
        sample, members, counts = mats
        b, ch = x.shape[:2]
        s = torch.bmm(sample, x.permute(0, 2, 3, 1).reshape(b, reso * reso, ch))
        c = level.fc_comm(s) + level.fc_c(c_last)
        plane = torch.bmm(members, c) / counts
        return plane.reshape(b, reso, reso, -1).permute(0, 3, 1, 2), c
    c = level.fc_comm(_sample_plane(x, xy, mask, cache)) + level.fc_c(c_last)
    return _scatter_plane(xy, c, reso, mask, cache), c


def _conv_pair(level: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The level-opening conv3x3(relu) x2 (reference alto.py:97-138): one K7
    call under ``fused_convs`` where the JAX package fuses it, else the
    composed convs; the same parameters either way."""
    if fusable(level.fused_convs, x):
        return fused_pair(level.conv1, level.conv2, x, False)[0]
    return level.conv2(level.conv1(x))


class AltoDownConv(nn.Module):
    """Encoder level (reference alto.py:48-138)."""

    def __init__(self, in_channels: int, features: int, level: int, pooling: bool,
                 prev_features: Optional[int], c_dim: int, fused_convs: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.level, self.pooling, self.fused_convs = level, pooling, fused_convs
        self.conv1 = Conv3x3(in_channels, features, relu=True, dtype=dtype)
        self.conv2 = Conv3x3(features, features, relu=True, dtype=dtype)
        self.res1x1 = conv1x1(prev_features, features, dtype) if prev_features else None
        self.fc_comm = MLP2(features, dtype)
        self.fc_c = Dense(c_dim, features, dtype=dtype)

    def forward(self, xy, x, x_after_conv, c_last, mask, cache):
        x = _conv_pair(self, x)
        if x_after_conv is not None:
            prev = max_pool_2x2(x_after_conv) if self.level >= 2 else x_after_conv
            x = x + self.res1x1(prev)
        x_after_conv = x
        x, c = _round_trip(self, x, xy, c_last, mask, cache)
        before_pool = x
        if self.pooling:
            x = max_pool_2x2(x)
        return x, before_pool, x_after_conv, c


class AltoUpConv(nn.Module):
    """Decoder level (reference alto.py:141-257); the last level makes no
    point round trip."""

    def __init__(self, up_channels: int, features: int, level: int, depth: int,
                 prev_features: int, c_dim: int, fused_convs: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.last = level == depth - 2
        self.fused_convs = fused_convs
        if self.last:
            self.upconv_noup = conv1x1(up_channels, features, dtype)
        else:
            self.upconv = upconv2x2(up_channels, features, dtype)
        self.conv1 = Conv3x3(2 * features, features, relu=True, dtype=dtype)
        self.conv2 = Conv3x3(features, features, relu=True, dtype=dtype)
        if self.last:
            self.res1x1 = conv1x1(prev_features, features, dtype)
        else:
            self.res_up = upconv2x2(prev_features, features, dtype)
            self.fc_comm = MLP2(features, dtype)
            self.fc_c = Dense(c_dim, features, dtype=dtype)

    def forward(self, xy, from_down, from_up, x_after_conv, c_last, mask, cache):
        from_up = self.upconv_noup(from_up) if self.last else self.upconv(from_up)
        x = _conv_pair(self, torch.cat([from_up, from_down], dim=1))
        x = x + (self.res1x1(x_after_conv) if self.last else self.res_up(x_after_conv))
        x_after_conv = x
        if self.last:
            return x, x_after_conv, c_last
        x, c = _round_trip(self, x, xy, c_last, mask, cache)
        return x, x_after_conv, c


class AltoUNet(nn.Module):
    """Dual-topology U-Net over a plane + point set (reference alto.py:260-382).

    Schedule for depth=5 on a 256^2 plane: down 32@256 -> 64@256 (pool) ->
    128@128 (pool) -> 256@64 (pool) -> 512@32; up 256@64 -> 128@128 -> 64@256
    -> 32@256 (no point round trip on the last).
    """

    def __init__(self, num_classes: int, in_channels: int, c_dim: int,
                 depth: int = 5, start_filts: int = 32, merge_mode: str = "concat",
                 up_mode: str = "transpose", sample_mode: str = "bilinear",
                 fused_convs: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if (merge_mode, up_mode, sample_mode) != ("concat", "transpose", "bilinear"):
            raise NotImplementedError(
                f"AltoUNet merge_mode={merge_mode!r} up_mode={up_mode!r} "
                f"sample_mode={sample_mode!r}: only concat/transpose/bilinear is "
                "ported (ROADMAP: alternates)")
        self.depth = depth
        feats = [start_filts * (2 ** i) for i in range(depth)]
        cin, cd = in_channels, c_dim
        for i in range(depth):
            pooling = 0 < i < depth - 1
            prev = feats[i - 1] if i > 0 else None
            self.add_module(f"down{i}", AltoDownConv(cin, feats[i], i, pooling, prev, cd,
                                                     fused_convs, dtype))
            cin = cd = feats[i]
        up_in = prev = feats[-1]
        for i in range(depth - 1):
            f = feats[depth - 2 - i]
            self.add_module(f"up{i}", AltoUpConv(up_in, f, i, depth, prev, cd, fused_convs,
                                                 dtype))
            up_in = prev = cd = f
        self.conv_final = conv1x1(start_filts, num_classes, dtype)

    def forward(self, points: torch.Tensor, plane: torch.Tensor, c: torch.Tensor,
                mask: torch.Tensor, buckets: Optional[Dict] = None) -> torch.Tensor:
        """
        Args:
            points: (B, N, >=2) normalized coordinates (xy used).
            plane: (B, R, R, C_in) NHWC initial plane.
            c: (B, N, C_in) initial point features.
            mask: (B, N) bool validity.
            buckets: the point encoder's sorted-layout metadata, else None
                (plain ops): {'impl', 'cells': (B, N) int32 finest Morton ids}
                plus 'tile_offsets' (``fused``, 256-cell tiles) or 'offsets'
                (``pallas``/``cumsum``, per cell).

        Returns:
            (B, R, R, num_classes) NHWC plane.
        """
        xy = points[..., :2]
        cache: Dict = {}
        if buckets is not None:
            cache.update(buckets)
            cache["finest"] = plane.shape[1]
            cache["xy"] = xy.contiguous()
        x = plane.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x_after_conv = None
        encoder_outs = []
        for i in range(self.depth):
            x, before_pool, x_after_conv, c = getattr(self, f"down{i}")(
                xy, x, x_after_conv, c, mask, cache)
            encoder_outs.append(before_pool)
        for i in range(self.depth - 1):
            x, x_after_conv, c = getattr(self, f"up{i}")(
                xy, encoder_outs[-(i + 2)], x, x_after_conv, c, mask, cache)
        return self.conv_final(x).permute(0, 2, 3, 1)
