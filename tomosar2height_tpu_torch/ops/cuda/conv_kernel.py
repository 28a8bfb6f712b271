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
bf16 inputs are upcast for it and each gradient is cast back to its
input's dtype, so a bf16 call's backward is the f32 composition's too; on
the CPU a bf16 call runs the plain version through :class:`PlainVjp` for
that reason (:func:`kernel_vjp`).

Each kernel takes bf16 activations as its JAX kernel does (bf16 operands,
f32 accumulation): K8 a bf16 x and kernel with the f32 bias, the sum of the
bf16 products in f32 onto the bias, the ReLU and one rounding to bf16
(conv_kernel.py:43-73). Its bf16 entry point is ``t2h_conv3x3_bf16``.

PyTorch runs a float32 cuDNN convolution in TF32 (about three decimal
digits) unless ``torch.backends.cudnn.allow_tf32`` is False, and that flag
is True by default. :func:`fp32_convs` turns it off around every cuDNN
convolution of the port (the plain versions here, the model's conv layers,
the backwards that :class:`PlainVjp` and ``Trainer.train_step`` run), so
the port computes in full float32 whatever the caller's flags are. The
training step's scope also asks cuDNN for deterministic algorithms
(``deterministic=True``): some of its default backward algorithms add in
no fixed order, and the JAX reference trains bit-exactly run to run.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from tomosar2height_tpu_torch.ops.cuda import runtime


@contextlib.contextmanager
def fp32_convs(deterministic: bool = False):
    """A scope in which cuDNN convolutions (forward, and the backwards that
    autograd runs inside it) compute in full float32, not TF32; with
    ``deterministic``, also only with deterministic algorithms (an inner
    scope without it keeps the outer one's choice). The caller's
    ``torch.backends.cudnn`` flags are restored on exit."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = False
    if deterministic:
        cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


def in_fp32_convs(fn):
    """``fn`` run inside :func:`fp32_convs`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with fp32_convs():
            return fn(*args, **kwargs)
    return wrapped


def upcast(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor in float32; any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


class PlainVjp(torch.autograd.Function):
    """``kernel(*tensors)`` forward; the backward differentiates
    ``plain(*tensors)`` (recomputed, bf16 tensors upcast to float32) with
    autograd and casts each gradient to its tensor's dtype. ``kernel`` and
    ``plain`` take the same tensors and return a tensor or a tuple of
    tensors."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        with torch.enable_grad(), fp32_convs():
            leaves = [upcast(a.detach()).requires_grad_(need)
                      for a, need in zip(args, ctx.needs_input_grad[2:])]
            outs = ctx.plain(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, upcast(g)) for o, g in zip(outs, grads)
                     if o is not None and g is not None]
            wanted = [a for a in leaves if a.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs], allow_unused=True))
            grads_in = [next(got) if a.requires_grad else None for a in leaves]
        return (None, None, *(None if g is None else g.to(a.dtype)
                              for a, g in zip(args, grads_in)))


def kernel_vjp(kernel, plain, *tensors):
    """A conv kernel's call on ``tensors`` (the first one the activations):
    on a CUDA tensor ``kernel``, on a CPU one ``plain``; differentiable by
    :class:`PlainVjp` (the f32 composition's backward). A CPU call that is
    not bf16 runs ``plain`` alone, with autograd through it."""
    if runtime.on_cpu(tensors[0]):
        if tensors[0].dtype != torch.bfloat16:
            return plain(*tensors)
        kernel = plain
    return PlainVjp.apply(kernel, plain, *tensors)


def bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to bf16 and back: the JAX bf16 kernels' cast
    of a parameter that they add in float32."""
    return t.to(torch.bfloat16).float()


@in_fp32_convs
def conv3x3_plain(x, w, b, relu: bool = False):
    """x (B, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO, b (Cout,) ->
    (B, H, W, Cout): ``F.conv2d`` SAME + bias (+ReLU), in full float32.
    bf16 x and w (b float32): their products summed in float32 onto b,
    then the ReLU and one rounding to bf16 (K8's bf16 rule)."""
    y = F.conv2d(upcast(x).permute(0, 3, 1, 2), upcast(w).permute(3, 2, 0, 1), b, padding=1)
    return (torch.relu(y) if relu else y).permute(0, 2, 3, 1).to(x.dtype)


def kernel_dtype(x: torch.Tensor) -> torch.dtype:
    """x's dtype where a conv kernel takes it (float32 or bf16), else raise."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    return x.dtype


def _conv3x3_kernel(x, w, b, relu: bool):
    dev = x.device
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    dt = kernel_dtype(x)
    runtime.require(x, "x", dt, (bsz, h, wd, cin), dev)
    runtime.require(w, "w", dt, (3, 3, cin, cout), dev)
    runtime.require(b, "b", torch.float32, (cout,), dev)
    y = torch.empty((bsz, h, wd, cout), device=dev, dtype=dt)
    name = "conv3x3" if dt == torch.float32 else "conv3x3_bf16"
    err = getattr(runtime.library(), f"t2h_{name}")(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout,
        int(relu), runtime.stream_ptr(dev))
    runtime.check(err, name)
    runtime.LAUNCHES[name] += 1
    return y


def conv3x3(x, w, b, relu: bool = False):
    """K8: a 3x3 SAME conv + bias (+ReLU). Same arguments and return as
    :func:`conv3x3_plain`; on a CUDA tensor x, w and b must be contiguous,
    x and w both float32 or both bf16 and b float32 (the NHWC view of a
    ``channels_last`` plane is contiguous), and the result is a contiguous
    NHWC tensor in x's dtype. Differentiable (plain backward)."""
    return kernel_vjp(lambda *a: _conv3x3_kernel(*a, relu),
                      lambda *a: conv3x3_plain(*a, relu), x, w, b)
