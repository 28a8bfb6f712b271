"""One 3x3 SAME convolution + bias (+ReLU) on NHWC tensors.

Counterpart of ``tomosar2height_tpu/ops/pallas/conv_kernel.py``. The CUDA
kernel K8 (``csrc/conv.cu``) replaces ``_conv_kernel`` (conv_kernel.py:43,
launched by ``_conv_impl``); every ``Conv3x3`` of the model runs it under
``models.blocks.set_fast_conv(True)``. What bounds it on the H100 and how the
design answers it is noted in the CUDA source: one implicit GEMM on the
tensor cores at fp32 accuracy (3xTF32, ``csrc/igemm_conv.cuh``). A CPU
tensor takes :func:`conv3x3_plain`, a CUDA tensor the kernel; there is no
fallback.

The three conv kernels (K6, K7, K8) differentiate as the JAX custom_vjps
do: the backward is the autograd of the plain composition in f32
(conv_kernel.py:153-171), run by :class:`PlainVjp`; no backward kernel.

PyTorch runs a float32 cuDNN convolution in TF32 (about three decimal
digits) unless ``torch.backends.cudnn.allow_tf32`` is False, and that flag
is True by default. :func:`fp32_convs` turns it off around every cuDNN
convolution of the port (the plain versions here, the model's conv layers,
the backwards that :class:`PlainVjp` and ``Trainer.train_step`` run), so
the port computes in full float32 whatever the caller's flags are.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from tomosar2height_tpu_torch.ops.cuda import runtime


@contextlib.contextmanager
def fp32_convs():
    """A scope in which cuDNN convolutions (forward, and the backwards that
    autograd runs inside it) compute in full float32, not TF32; the
    caller's ``torch.backends.cudnn.allow_tf32`` is restored on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def in_fp32_convs(fn):
    """``fn`` run inside :func:`fp32_convs`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with fp32_convs():
            return fn(*args, **kwargs)
    return wrapped


class PlainVjp(torch.autograd.Function):
    """``kernel(*tensors)`` forward; the backward differentiates
    ``plain(*tensors)`` (recomputed) with autograd. ``kernel`` and ``plain``
    take the same tensors and return a tensor or a tuple of tensors."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        with torch.enable_grad(), fp32_convs():
            leaves = [a.detach().requires_grad_(need)
                      for a, need in zip(args, ctx.needs_input_grad[2:])]
            outs = ctx.plain(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o is not None and g is not None]
            wanted = [a for a in leaves if a.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs], allow_unused=True))
        return (None, None, *(next(got) if a.requires_grad else None for a in leaves))


@in_fp32_convs
def conv3x3_plain(x, w, b, relu: bool = False):
    """x (B, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO, b (Cout,) ->
    (B, H, W, Cout): ``F.conv2d`` SAME + bias (+ReLU), in full float32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    return (torch.relu(y) if relu else y).permute(0, 2, 3, 1)


def _check_conv(x, w, b) -> None:
    dev = x.device
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    f32 = torch.float32
    runtime.require(x, "x", f32, (bsz, h, wd, cin), dev)
    runtime.require(w, "w", f32, (3, 3, cin, cout), dev)
    runtime.require(b, "b", f32, (cout,), dev)


def _conv3x3_kernel(x, w, b, relu: bool):
    _check_conv(x, w, b)
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((bsz, h, wd, cout), device=x.device, dtype=torch.float32)
    err = runtime.library().t2h_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout,
        int(relu), runtime.stream_ptr(x.device))
    runtime.check(err, "conv3x3")
    runtime.LAUNCHES["conv3x3"] += 1
    return y


def conv3x3(x, w, b, relu: bool = False):
    """K8: a 3x3 SAME conv + bias (+ReLU). Same arguments and return as
    :func:`conv3x3_plain`; on a CUDA tensor x, w and b must be contiguous
    f32 (the NHWC view of a ``channels_last`` plane is), and the result is a
    contiguous NHWC tensor. Differentiable (plain backward)."""
    if runtime.on_cpu(x):
        return conv3x3_plain(x, w, b, relu)
    return PlainVjp.apply(lambda *a: _conv3x3_kernel(*a, relu),
                          lambda *a: conv3x3_plain(*a, relu), x, w, b)
