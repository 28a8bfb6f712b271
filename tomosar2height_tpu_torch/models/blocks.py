"""Shared building blocks. Counterpart of ``tomosar2height_tpu/models/blocks.py``
(reference block/resnet.py:4-54).

Attribute names follow the flax module names, so a ``state_dict`` key is the
flax parameter path joined with dots (``utils/torch_port.py`` relies on it).
Convolutions are NCHW-logical; the U-Net keeps its planes in
``torch.channels_last`` memory, so an NHWC view of a plane costs no copy.
Every conv layer runs its cuDNN convolution in full float32, whatever the
caller's TF32 flags (``ops/cuda/conv_kernel.fp32_convs``).

The dtype policy is the JAX package's ``model.dtype``: each layer takes a
``dtype`` (float32 by default) and computes in it, as a flax layer built
with ``dtype=``. Parameters stay float32; under bfloat16 a layer casts its
input, weight and bias to bf16 (:func:`cast`, flax's ``promote_dtype``),
takes the product in bf16 (float32 accumulation, the output rounded) and adds
the bias in bf16, so it returns bf16. A float32 layer runs the code it always
ran.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tomosar2height_tpu_torch.ops.cuda.conv_kernel import conv3x3, in_fp32_convs
from tomosar2height_tpu_torch.ops.cuda.convpair_kernel import conv_pair


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
"""``model.dtype`` values the port computes in."""


def cast(dtype: torch.dtype, *tensors):
    """The tensors in ``dtype`` (None passes): a layer's input and
    parameters under flax's ``promote_dtype``."""
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform kernels and zero biases, drawn in module order from
    ``generator`` (the JAX package's init, models/blocks.py:13). The draws
    are made on the CPU and copied to the module's device, so a CPU
    generator gives the same weights on any device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
            nn.init.xavier_uniform_(w, generator=generator)
            with torch.no_grad():
                m.weight.copy_(w)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


class Dense(nn.Linear):
    """``nn.Linear`` in ``dtype`` (flax ``nn.Dense(dtype=...)``): under bf16
    the product of the cast input and weight, then the cast bias added."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        x, w, b = cast(self.dtype, x, self.weight, self.bias)
        y = F.linear(x, w)
        return y if b is None else y + b


class ResnetBlockFC(nn.Module):
    """x_s + fc_1(relu(fc_0(relu(x)))), linear shortcut when the width changes."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        size_out = size_in if size_out is None else size_out
        size_h = min(size_in, size_out)
        self.fc_0 = Dense(size_in, size_h, dtype=dtype)
        self.fc_1 = Dense(size_h, size_out, dtype=dtype)
        self.shortcut = (Dense(size_in, size_out, bias=False, dtype=dtype)
                         if size_in != size_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        x_s = self.shortcut(x) if self.shortcut is not None else x
        return x_s + dx


# 3x3 conv backend: False (default) = F.conv2d; True = the hand-written
# kernel K8 (ops/cuda/conv_kernel.py); None = K8 on CUDA tensors. The JAX
# package's FAST_CONV (models/blocks.py:57-79), whose None means "on a TPU".
FAST_CONV = {"enabled": False}


def set_fast_conv(enabled: Optional[bool]) -> None:
    """Select the backend of every ``Conv3x3`` called from now on."""
    FAST_CONV["enabled"] = enabled


def _fast_conv_on(x: torch.Tensor) -> bool:
    on = FAST_CONV["enabled"]
    return x.is_cuda if on is None else bool(on)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, C) view of an NCHW plane: no copy on ``channels_last``
    memory (the U-Nets' planes)."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(y: torch.Tensor) -> torch.Tensor:
    """The NCHW (``channels_last`` memory) view of an NHWC tensor."""
    return y.permute(0, 3, 1, 2)


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's (O, I, kh, kw) weight as the kernels' (kh, kw, I, O)."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()


class Conv3x3(nn.Conv2d):
    """3x3 SAME conv with an optional fused ReLU (NCHW); K8 under
    :func:`set_fast_conv`. Under bf16 (JAX models/blocks.py:95-110) x and
    the kernel are cast; K8 takes them with the float32 bias, the plain path
    rounds the conv to bf16 and adds the bf16 bias."""

    def __init__(self, cin: int, cout: int, relu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 3, padding=1)
        self.use_relu = relu
        self.dtype = dtype

    @in_fp32_convs
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.dtype != torch.float32:
            x, w = cast(self.dtype, x, w)
        if _fast_conv_on(x):
            return nchw(conv3x3(nhwc(x), w.permute(2, 3, 1, 0).contiguous(), self.bias,
                                self.use_relu))
        if self.dtype == torch.float32:
            y = super().forward(x)
        else:
            y = F.conv2d(x, w, padding=1) + self.bias.to(self.dtype)[:, None, None]
        return torch.relu(y) if self.use_relu else y


def fusable(fused_convs: bool, x: torch.Tensor) -> bool:
    """Whether a level's conv pair runs as one K7 call: the JAX package's
    rule (models/unet.py:18-23, models/alto.py:176) on an NCHW plane."""
    h, w = x.shape[-2:]
    return fused_convs and h % 8 == 0 and h >= 8 and w % 8 == 0


def fused_pair(conv1: Conv3x3, conv2: Conv3x3, x: torch.Tensor, pool: bool):
    """K7 over conv1 -> conv2 (both with ReLU) on an NCHW plane: (y, pooled
    or None), NCHW on ``channels_last`` memory. x goes in conv1's dtype; the
    float32 parameters are cast inside, as the JAX kernel's are."""
    if conv1.dtype != torch.float32:
        x = x.to(conv1.dtype)
    y, pooled = conv_pair(nhwc(x), hwio(conv1), conv1.bias, hwio(conv2), conv2.bias, pool)
    return nchw(y), (nchw(pooled) if pool else None)


class Conv1x1(nn.Conv2d):
    """1x1 conv (full float32, or in ``dtype`` as flax ``nn.Conv``)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 1)
        self.dtype = dtype

    @in_fp32_convs
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        x, w, b = cast(self.dtype, x, self.weight, self.bias)
        return F.conv2d(x, w) + b[:, None, None]


class UpConv2x2(nn.ConvTranspose2d):
    """2x2 stride-2 transpose conv (full float32, or in ``dtype`` as flax
    ``nn.ConvTranspose``): exactly 2x the spatial size."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 2, stride=2)
        self.dtype = dtype

    @in_fp32_convs
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        x, w, b = cast(self.dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, stride=2) + b[:, None, None]


def conv1x1(cin: int, cout: int, dtype: torch.dtype = torch.float32) -> nn.Conv2d:
    return Conv1x1(cin, cout, dtype)


def upconv2x2(cin: int, cout: int, dtype: torch.dtype = torch.float32) -> nn.ConvTranspose2d:
    return UpConv2x2(cin, cout, dtype)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class MLP2(nn.Module):
    """Linear(d, 2d) -> ReLU -> Linear(2d, d): ALTO's ``fc_comm``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_in = Dense(features, 2 * features, dtype=dtype)
        self.fc_out = Dense(2 * features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(torch.relu(self.fc_in(x)))
