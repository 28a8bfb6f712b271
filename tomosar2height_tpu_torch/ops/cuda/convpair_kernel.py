"""A fused conv3x3+ReLU pair with an optional 2x2 max pool, NHWC.

Counterpart of ``tomosar2height_tpu/ops/pallas/convpair_kernel.py``. The
CUDA kernel K7 (``csrc/convpair.cu``) replaces ``_pair_kernel``
(convpair_kernel.py:36, launched by ``_pair_impl``): under ``fused_convs``
it opens every ALTO level (``models/alto.py``) and every image U-Net level
(``models/unet.py``), the down-levels with its pooled output. What bounds it
on the H100 and how the design answers it is noted in the CUDA sources
(``csrc/convpair.cu`` on the implicit-GEMM core ``csrc/igemm_conv.cuh`` in
f32; ``csrc/conv_bf16.cu`` in bf16). A
CPU tensor takes :func:`conv_pair_plain`, a CUDA tensor the kernel; there is no
fallback. The backward is the plain composition's autograd in f32, as the
JAX custom_vjp's (convpair_kernel.py:161-170).

A bf16 x takes the JAX kernel's bf16 rule (convpair_kernel.py:122-142): the
float32 weights and biases rounded to bf16, f32 accumulation, relu(conv1)
rounded to bf16 before conv2, and the output and pool in bf16
(``t2h_conv_pair_bf16``, ``csrc/conv_bf16.cu``: each conv on K8's TMA-fed
wgmma pipeline, the pool in the second conv's epilogue; a conv whose Cin or
Cout is not a multiple of 8 (Cin = 3), or whose tensors are not 16-byte
aligned, on the conv core's flat-K path; its convs counted by route,
``conv_pair_bf16_wgmma`` and ``conv_pair_bf16_flat``). The weights'
gradients stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tomosar2height_tpu_torch.ops.cuda import runtime, tile_plan
from tomosar2height_tpu_torch.ops.cuda.conv_kernel import (
    bf16_rounded,
    conv3x3_plain,
    kernel_dtype,
    kernel_vjp,
)


def conv_pair_plain(x, w1, b1, w2, b2, pool: bool = False):
    """relu(conv(relu(conv(x, w1) + b1), w2) + b2) and, with ``pool``, its
    2x2 max pool. x (B, H, W, Cin) NHWC; w1 (3, 3, Cin, C1), w2 (3, 3, C1, C2)
    HWIO. Returns (y (B, H, W, C2), pooled (B, H/2, W/2, C2) or None), in
    x's dtype (bf16: the weights and biases rounded to bf16, each conv's
    output rounded, K8's rule)."""
    dt = x.dtype
    if dt == torch.bfloat16:
        w1, b1, w2, b2 = w1.to(dt), bf16_rounded(b1), w2.to(dt), bf16_rounded(b2)
    y = conv3x3_plain(conv3x3_plain(x, w1, b1, True), w2, b2, True)
    if not pool:
        return y, None
    return y, F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _conv_pair_kernel(x, w1, b1, w2, b2, pool: bool):
    dev = x.device
    bsz, h, wd, cin = x.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    dt, f32 = kernel_dtype(x), torch.float32
    runtime.require(x, "x", dt, (bsz, h, wd, cin), dev)
    runtime.require(w1, "w1", f32, (3, 3, cin, c1), dev)
    runtime.require(b1, "b1", f32, (c1,), dev)
    runtime.require(w2, "w2", f32, (3, 3, c1, c2), dev)
    runtime.require(b2, "b2", f32, (c2,), dev)
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"conv_pair: pooling needs an even plane, got {h}x{wd}")
    name = "conv_pair"
    if dt == torch.bfloat16:  # the JAX kernel's casts (convpair_kernel.py:141-142)
        name = "conv_pair_bf16"
        w1, b1, w2, b2 = w1.to(dt), bf16_rounded(b1), w2.to(dt), bf16_rounded(b2)
    mid = torch.empty((bsz, h, wd, c1), device=dev, dtype=dt)  # relu(conv1)
    y = torch.empty((bsz, h, wd, c2), device=dev, dtype=dt)
    pooled = torch.empty((bsz, h // 2, wd // 2, c2), device=dev, dtype=dt) if pool else None
    err = getattr(runtime.library(), f"t2h_{name}")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        mid.data_ptr(), y.data_ptr(), pooled.data_ptr() if pool else None, bsz, h, wd, cin,
        c1, c2, runtime.stream_ptr(dev))
    runtime.check(err, name)
    runtime.LAUNCHES[name] += 1
    if dt == torch.bfloat16:
        for cin_, cout_, ts in ((cin, c1, (x, w1, mid)), (c1, c2, (mid, w2, y, pooled))):
            aligned = all(t.data_ptr() % 16 == 0 for t in ts if t is not None)
            runtime.LAUNCHES[f"{name}_{tile_plan.conv_route(cin_, cout_, aligned)}"] += 1
    return (y, pooled) if pool else y


def conv_pair(x, w1, b1, w2, b2, pool: bool = False):
    """K7: the conv pair (+ pool). Same arguments and returns as
    :func:`conv_pair_plain`; on a CUDA tensor every input must be contiguous,
    x float32 or bf16 and the weights and biases float32 (the NHWC view of a
    ``channels_last`` plane is contiguous), and H and W even when pooling.
    The kernel runs the two convs as implicit GEMMs on the tensor cores
    (3xTF32 ``mma.sync`` at fp32 accuracy, or bf16 ``wgmma`` fed by the TMA),
    relu(conv1) through a (B, H, W, C1) scratch tensor. Differentiable
    (plain backward)."""
    if pool:
        return kernel_vjp(lambda *a: _conv_pair_kernel(*a, True),
                          lambda *a: conv_pair_plain(*a, True), x, w1, b1, w2, b2)
    y = kernel_vjp(lambda *a: _conv_pair_kernel(*a, False),
                   lambda *a: conv_pair_plain(*a, False)[0], x, w1, b1, w2, b2)
    return y, None
