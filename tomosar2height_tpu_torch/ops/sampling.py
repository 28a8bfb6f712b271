"""Bilinear plane sampling at point coordinates (grid_sample replacement).

Counterpart of ``tomosar2height_tpu/ops/sampling.py``: torch
``F.grid_sample(plane, 2*xy-1, padding_mode='border', align_corners=True)``
semantics on an NHWC plane. A normalized coordinate u in [0, 1] maps to pixel
``u * (size - 1)``; out-of-range positions clamp to the border.
"""

from __future__ import annotations

import torch


def _corners(coords: torch.Tensor, h: int, w: int):
    """Pixel indices (x0, y0, x1, y1) and weights (wx, wy), each (B, N, 1)
    for the weights, of the bilinear sample at xy in [0, 1]."""
    x = (coords[..., 0] * (w - 1)).clamp(0.0, w - 1)
    y = (coords[..., 1] * (h - 1)).clamp(0.0, h - 1)
    x0 = torch.floor(x).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(y).to(torch.int32).clamp(0, h - 1)
    wx = (x - x0.to(x.dtype))[..., None]
    wy = (y - y0.to(y.dtype))[..., None]
    # at the last pixel the +1 neighbour has weight exactly 0: clamp its index
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    return x0, y0, x1, y1, wx, wy


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a (B, H, W, C) plane (row = y, col = x) at (B, N, 2)
    xy in [0, 1]; returns (B, N, C)."""
    b, h, w, c = plane.shape
    flat = plane.reshape(b, h * w, c)

    def take(yi, xi):
        idx = (yi * w + xi).long()[..., None].expand(*yi.shape, c)
        return torch.gather(flat, 1, idx)

    x0, y0, x1, y1, wx, wy = _corners(coords, h, w)
    top = take(y0, x0) * (1 - wx) + take(y0, x1) * wx
    bot = take(y1, x0) * (1 - wx) + take(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def bilinear_matrix(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, N, H*W) weights of :func:`grid_sample_2d`: row i holds point i's
    four bilinear weights at its pixels, so ``bilinear_matrix(xy, H, W) @
    plane.reshape(B, H*W, C)`` is the sample, and the transposed product its
    adjoint, both as dense products in a fixed order. Where two of a point's
    corners share a pixel (the clamp at the last pixel), one of their weights
    is exactly 0, so the one add that can collide adds a zero."""
    b, n, _ = coords.shape
    x0, y0, x1, y1, wx, wy = _corners(coords, h, w)
    idx = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1], -1).long()
    wts = torch.cat([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], -1)
    out = torch.zeros(b, n, h * w, device=coords.device, dtype=coords.dtype)
    return out.scatter_add_(2, idx, wts)


def grid_sample_2d_adjoint(g: torch.Tensor, coords: torch.Tensor, h: int,
                           w: int) -> torch.Tensor:
    """The transpose of :func:`grid_sample_2d`: add each point's (B, N, C)
    cotangent into its four pixels of a (B, H, W, C) plane, weighted as the
    sample weighs them."""
    b, n, c = g.shape
    x0, y0, x1, y1, wx, wy = _corners(coords, h, w)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None]
    out = torch.zeros(b * h * w, c, device=g.device, dtype=g.dtype)
    for yi, xi, wgt in ((y0, x0, (1 - wx) * (1 - wy)), (y0, x1, wx * (1 - wy)),
                        (y1, x0, (1 - wx) * wy), (y1, x1, wx * wy)):
        idx = (base + (yi * w + xi).long()).reshape(-1)
        out.index_add_(0, idx, (g * wgt).reshape(b * n, c))
    return out.reshape(b, h, w, c)
