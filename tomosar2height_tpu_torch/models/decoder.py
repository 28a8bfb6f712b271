"""Pixelwise decoder: upsample the feature planes to the output raster, sum
them and decode heights (and footprint logits). Counterpart of
``tomosar2height_tpu/models/decoder.py`` (reference decoder/pixel.py), conv
mode. Under ``fused_head`` each ConvDecoder is one K6 call
(``ops/cuda/decoder_kernel.conv_decoder``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tomosar2height_tpu_torch.models.blocks import Conv3x3, hwio
from tomosar2height_tpu_torch.ops.cuda.conv_kernel import in_fp32_convs
from tomosar2height_tpu_torch.ops.cuda.decoder_kernel import conv_decoder
from tomosar2height_tpu_torch.ops.resize import resize_bilinear


class Conv1x1Split(nn.Conv2d):
    """1x1 conv over a virtual channel concat, applied per part with sliced
    weights and summed: the concat (288 channels at 512^2) is never built.
    Parameters as ``nn.Conv2d(sum(Ci), out, 1)``; full float32."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    @in_fp32_convs
    def forward(self, parts) -> torch.Tensor:
        out, off = None, 0
        for p in parts:
            c = p.shape[1]
            y = F.conv2d(p, self.weight[:, off:off + c])
            out = y if out is None else out + y
            off += c
        return out + self.bias[None, :, None, None]


class ConvDecoder(nn.Module):
    """conv3x3+ReLU chain C->64->128->64 + 1x1 over the dense concat
    [x, x1, x2, x3] (reference pixel.py:8-32); one K6 call when ``fused``."""

    def __init__(self, in_channels: int, out_channels: int = 1, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.conv1 = Conv3x3(in_channels, 64, relu=True)
        self.conv2 = Conv3x3(64, 128, relu=True)
        self.conv3 = Conv3x3(128, 64, relu=True)
        self.conv4 = Conv1x1Split(in_channels + 256, out_channels)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """(B, S, S, C) NHWC -> (B, S, S, out_channels) NHWC."""
        if self.fused:
            return conv_decoder(c.contiguous(), *(t for conv in (self.conv1, self.conv2,
                                                                 self.conv3, self.conv4)
                                                  for t in (hwio(conv), conv.bias)))
        x = c.permute(0, 3, 1, 2)
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        return self.conv4([x, x1, x2, x3]).permute(0, 2, 3, 1)


class PixelwiseDecoder(nn.Module):
    """{'xy': (B, R, R, C)[, 'image': (B, R', R', C)]} -> (height (B, S, S,
    out_dim), footprint logits (B, S, S, out_dim) or None) (reference
    pixel.py:61-125): the planes are resized to S and summed.
    ``hidden_dim`` and ``sample_mode`` are config keys the conv decoder does
    not read."""

    def __init__(self, in_channels: int, hidden_dim: int = 32, out_dim: int = 1,
                 output_size: int = 512, leaky: bool = False,
                 sample_mode: str = "bilinear", mode: str = "conv",
                 use_footprint: bool = False, fused_head: bool = False):
        super().__init__()
        if mode != "conv" or leaky:
            raise NotImplementedError(
                f"decoder mode={mode!r}, leaky={leaky}: only the conv decoder "
                "with ReLU is ported (ROADMAP: alternates)")
        self.output_size = output_size
        self.conv_decoder = ConvDecoder(in_channels, out_dim, fused_head)
        self.conv_decoder_footprint = (ConvDecoder(in_channels, out_dim, fused_head)
                                       if use_footprint else None)

    def forward(self, feature_planes: dict, footprint: bool = True):
        """``footprint=False`` skips the footprint head (serving reads only
        the heights)."""
        planes = [resize_bilinear(feature_planes[k], self.output_size)
                  for k in ("xy", "image") if k in feature_planes]
        c = planes[0] if len(planes) == 1 else planes[0] + planes[1]
        x = self.conv_decoder(c)
        if self.conv_decoder_footprint is None or not footprint:
            return x, None
        return x, self.conv_decoder_footprint(c)
