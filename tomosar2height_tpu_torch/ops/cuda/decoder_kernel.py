"""The whole ConvDecoder (three conv3x3+ReLU and the dense-skip 1x1 head) in
one kernel, NHWC.

Counterpart of ``tomosar2height_tpu/ops/pallas/decoder_kernel.py``. The CUDA
kernel K6 (``csrc/decoder.cu``) replaces ``_decoder_kernel``
(decoder_kernel.py:85, launched by ``_fused_fwd_impl``); the pixel decoder
runs it under ``decoder_pixel_kwargs.fused_head``. What bounds it on the
H100 and how the design answers it is noted in the CUDA source: three
implicit-GEMM convs on the tensor cores at fp32 accuracy (3xTF32, on
``csrc/igemm_conv.cuh``), three CUDA launches a call, the head in the third
conv's epilogue. A CPU tensor
takes :func:`conv_decoder_plain`, a CUDA tensor the kernel; there is no
fallback. The backward is the plain composition's autograd in f32, as the
JAX custom_vjp's (decoder_kernel.py:274-279).

A bf16 x takes the JAX kernel's bf16 rule (decoder_kernel.py:242-267): every
weight and bias (w4 and b4 too) rounded to bf16, x1, x2 and x3 rounded to
bf16, f32 accumulation, and the head's sum of bf16 parts times bf16 w4 in
f32 onto the rounded b4; the output is float32 (``t2h_conv_decoder_bf16``,
``csrc/conv_bf16.cu``: the three convs on K8's TMA-fed wgmma pipeline, the
head in the third's epilogue; a conv whose widths are not multiples of 8, or
whose tensors are not 16-byte aligned, on the conv core instead; its convs
counted by route, ``conv_decoder_bf16_wgmma`` and ``conv_decoder_bf16_flat``,
``tile_plan.decoder_plan``).
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime, tile_plan
from tomosar2height_tpu_torch.ops.cuda.conv_kernel import (
    bf16_rounded,
    conv3x3_plain,
    kernel_dtype,
    kernel_vjp,
    upcast,
)


def conv_decoder_plain(x, w1, b1, w2, b2, w3, b3, w4, b4):
    """x (B, H, W, C) NHWC; w1..w3 (3, 3, Cin, Cout) HWIO; w4 (1, 1, C + C1 +
    C2 + C3, Cout) -> (B, H, W, Cout): x1..x3 = relu(conv3x3) in a chain, then
    b4 + [x, x1, x2, x3] @ w4, the concat never built (the JAX
    ``_xla_decoder``). A bf16 x: the module docstring's rule; float32 out."""
    if x.dtype == torch.bfloat16:
        dt = x.dtype
        w1, w2, w3, w4 = (w.to(dt) for w in (w1, w2, w3, w4))
        b1, b2, b3, b4 = (bf16_rounded(b) for b in (b1, b2, b3, b4))
    x1 = conv3x3_plain(x, w1, b1, True)
    x2 = conv3x3_plain(x1, w2, b2, True)
    x3 = conv3x3_plain(x2, w3, b3, True)
    out, off = b4, 0
    for p in (x, x1, x2, x3):
        c = p.shape[-1]
        out = out + upcast(p) @ upcast(w4[0, 0, off:off + c])
        off += c
    return out


MAX_C3 = 64
"""Widest x3 the kernel takes: one block's tile covers all of its channels."""


def _conv_decoder_kernel(x, w1, b1, w2, b2, w3, b3, w4, b4):
    dev = x.device
    bsz, h, wd, c0 = x.shape
    c1, c2, c3, co = w1.shape[-1], w2.shape[-1], w3.shape[-1], w4.shape[-1]
    if c3 > MAX_C3:
        raise ValueError(f"conv_decoder: the kernel runs the head on one tile of x3's "
                         f"channels, at most {MAX_C3}; got C3 = {c3}")
    dt, f32 = kernel_dtype(x), torch.float32
    runtime.require(x, "x", dt, (bsz, h, wd, c0), dev)
    for name, t, shape in (("w1", w1, (3, 3, c0, c1)), ("b1", b1, (c1,)),
                           ("w2", w2, (3, 3, c1, c2)), ("b2", b2, (c2,)),
                           ("w3", w3, (3, 3, c2, c3)), ("b3", b3, (c3,)),
                           ("w4", w4, (1, 1, c0 + c1 + c2 + c3, co)), ("b4", b4, (co,))):
        runtime.require(t, name, f32, shape, dev)
    name = "conv_decoder"
    if dt == torch.bfloat16:  # the JAX kernel's casts (decoder_kernel.py:262-267)
        name = "conv_decoder_bf16"
        w1, w2, w3, w4 = (w.to(dt) for w in (w1, w2, w3, w4))
        b1, b2, b3, b4 = (bf16_rounded(b) for b in (b1, b2, b3, b4))
    x1 = torch.empty((bsz, h, wd, c1), device=dev, dtype=dt)  # relu(conv1)
    x2 = torch.empty((bsz, h, wd, c2), device=dev, dtype=dt)  # relu(conv2)
    out = torch.empty((bsz, h, wd, co), device=dev, dtype=f32)
    err = getattr(runtime.library(), f"t2h_{name}")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(), x1.data_ptr(),
        x2.data_ptr(), out.data_ptr(), bsz, h, wd, c0, c1, c2, c3, co,
        runtime.stream_ptr(dev))
    runtime.check(err, name)
    runtime.LAUNCHES[name] += 1
    if dt == torch.bfloat16:
        aligned = [all(t.data_ptr() % 16 == 0 for t in ts)
                   for ts in ((x, w1, x1), (x1, w2, x2), (x, x1, x2, w3))]
        for route in tile_plan.decoder_plan(bsz, h, wd, c0, c1, c2, c3, co, 1,
                                            aligned)["routes"]:
            runtime.LAUNCHES[f"{name}_{route}"] += 1
    return out


def conv_decoder(x, w1, b1, w2, b2, w3, b3, w4, b4):
    """K6: the fused ConvDecoder. Same arguments and return as
    :func:`conv_decoder_plain`; on a CUDA tensor every input must be
    contiguous, x float32 or bf16 and the weights and biases float32, and C3
    (x3's width) at most :data:`MAX_C3`, the model's, else it raises. x1 and
    x2 go through (B, H, W, C1) and (B, H, W, C2) scratch tensors in x's
    dtype; x3 stays in the kernel. Differentiable (plain backward)."""
    return kernel_vjp(_conv_decoder_kernel, conv_decoder_plain,
                      x, w1, b1, w2, b2, w3, b3, w4, b4)
