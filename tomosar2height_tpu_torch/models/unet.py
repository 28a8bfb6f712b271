"""Plain 2D U-Net: the image encoder of the cloud+image fusion network.

Counterpart of ``tomosar2height_tpu/models/unet.py`` (reference
encoder/unet.py:112-187): ``depth`` levels of (conv3x3-ReLU x2 [+ 2x2 max
pool]), channels doubling from ``start_filts``; a decoder of 2x2 transpose
convs, concat merges and conv pairs; a final 1x1 conv to ``num_classes``.
Under ``fused_convs`` each level's conv pair is one K7 call
(``ops/cuda/convpair_kernel.conv_pair``), whose pooled output feeds the next
down-level, where the JAX package fuses it (``blocks.fusable``). Planes are
NCHW-logical in ``channels_last`` memory; the public interface is NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tomosar2height_tpu_torch.models.blocks import (
    Conv3x3,
    conv1x1,
    fusable,
    fused_pair,
    max_pool_2x2,
    upconv2x2,
)


class DownConv(nn.Module):
    """(conv3x3 + ReLU) x2, optional 2x2 max pool (reference unet.py:48-73)."""

    def __init__(self, in_channels: int, features: int, pooling: bool,
                 fused_convs: bool = False):
        super().__init__()
        self.pooling, self.fused_convs = pooling, fused_convs
        self.conv1 = Conv3x3(in_channels, features, relu=True)
        self.conv2 = Conv3x3(features, features, relu=True)

    def forward(self, x):
        """Returns (the next level's input, before_pool)."""
        if fusable(self.fused_convs, x):
            before_pool, pooled = fused_pair(self.conv1, self.conv2, x, self.pooling)
            return (pooled if self.pooling else before_pool), before_pool
        before_pool = self.conv2(self.conv1(x))
        return (max_pool_2x2(before_pool) if self.pooling else before_pool), before_pool


class UpConv(nn.Module):
    """2x2 transpose-conv upsample + concat merge + (conv3x3 + ReLU) x2
    (reference unet.py:76-109)."""

    def __init__(self, in_channels: int, features: int, fused_convs: bool = False):
        super().__init__()
        self.fused_convs = fused_convs
        self.upconv = upconv2x2(in_channels, features)
        self.conv1 = Conv3x3(2 * features, features, relu=True)
        self.conv2 = Conv3x3(features, features, relu=True)

    def forward(self, from_down, from_up):
        x = torch.cat([self.upconv(from_up), from_down], dim=1)
        if fusable(self.fused_convs, x):
            return fused_pair(self.conv1, self.conv2, x, False)[0]
        return self.conv2(self.conv1(x))


class UNet(nn.Module):
    """Encoder-decoder over an image (reference unet.py:112-187). Only
    ``up_mode='transpose'`` with ``merge_mode='concat'`` (the fusion
    config's) is ported."""

    def __init__(self, num_classes: int, in_channels: int = 3, depth: int = 5,
                 start_filts: int = 64, up_mode: str = "transpose",
                 merge_mode: str = "concat", fused_convs: bool = False):
        super().__init__()
        if (up_mode, merge_mode) != ("transpose", "concat"):
            raise NotImplementedError(
                f"UNet up_mode={up_mode!r} merge_mode={merge_mode!r}: only "
                "transpose/concat is ported (ROADMAP: alternates)")
        self.depth = depth
        cin = in_channels
        for i in range(depth):
            f = start_filts * 2 ** i
            self.add_module(f"down{i}", DownConv(cin, f, i < depth - 1, fused_convs))
            cin = f
        for i in range(depth - 1):
            self.add_module(f"up{i}", UpConv(cin, cin // 2, fused_convs))
            cin //= 2
        self.conv_final = conv1x1(cin, num_classes)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) NHWC -> (B, H, W, num_classes) NHWC."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        encoder_outs = []
        for i in range(self.depth):
            x, before_pool = getattr(self, f"down{i}")(x)
            encoder_outs.append(before_pool)
        for i in range(self.depth - 1):
            x = getattr(self, f"up{i}")(encoder_outs[-(i + 2)], x)
        return self.conv_final(x).permute(0, 2, 3, 1)
