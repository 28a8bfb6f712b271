"""Bilinear resize with ``align_corners=True`` on NHWC tensors.

Counterpart of ``tomosar2height_tpu/ops/resize.py:resize_bilinear`` (reference
decoder/pixel.py:105-111): upsamples the 256^2 point-feature plane to the
512^2 output raster. The JAX package contracts two interpolation matrices on
the MXU, forward and backward. Here the forward is ``F.interpolate``, whose
align_corners=True weights are the same; on ``channels_last`` memory the
permutes below copy nothing. The backward contracts the cotangent with the
transposes of the two interpolation matrices (``torch.matmul``), as the JAX
package's does: ``F.interpolate``'s own backward adds into each input pixel
with atomics on the card, in no fixed order, so a training step would not be
bit-equal run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interp_matrix(n_out: int, n_in: int, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) align_corners=True linear interpolation weights, in
    ``like``'s dtype and on its device, computed as ``F.interpolate``
    computes them (source index o * scale in that dtype, the +1 neighbour
    clamped to the last pixel)."""
    dev, dt = like.device, like.dtype
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = torch.arange(n_out, device=dev, dtype=dt) * torch.tensor(scale, device=dev,
                                                                    dtype=dt)
    i0 = src.floor().clamp(0, n_in - 1)
    frac = (src - i0)[:, None]
    i0 = i0.long()[:, None]
    i1 = (i0 + 1).clamp(max=n_in - 1)
    cols = torch.arange(n_in, device=dev)[None, :]
    return (1 - frac) * (cols == i0) + frac * (cols == i1)


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[1:3])
        y = F.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
                          align_corners=True)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        (h, w), (b, ho, wo, c) = ctx.in_hw, g.shape
        # g (B, Ho, Wo, C): contract Wo with the width matrix, then Ho with
        # the height matrix; each output element is one fixed-order sum
        t = torch.matmul(interp_matrix(wo, w, g).t(), g)  # (B, Ho, W, C)
        dx = torch.matmul(interp_matrix(ho, h, g).t(), t.reshape(b, ho, w * c))
        return dx.reshape(b, h, w, c), None


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, H, W, C) -> (B, H_out, W_out, C), align_corners=True; its gradient
    is the contraction with the interpolation matrices (module docstring)."""
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    return _ResizeBilinear.apply(x, tuple(out_hw))
