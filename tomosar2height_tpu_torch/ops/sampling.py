"""Bilinear plane sampling at point coordinates (grid_sample replacement).

Counterpart of ``tomosar2height_tpu/ops/sampling.py``: torch
``F.grid_sample(plane, 2*xy-1, padding_mode='border', align_corners=True)``
semantics on an NHWC plane. A normalized coordinate u in [0, 1] maps to pixel
``u * (size - 1)``; out-of-range positions clamp to the border. The sample's
gathers and the adjoint's adds run in a fixed order on the card
(``ops/scatter.py``: ``gather_cells``, ``index_add_rows``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tomosar2height_tpu_torch.ops.scatter import (
    TRASH_ROWS,
    flat_segments,
    gather_cells,
    index_add_rows,
)


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


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear sample of a (B, H, W, C) plane (row = y, col = x) at (B, N, 2)
    xy in [0, 1]; returns (B, N, C). With a (B, N) ``mask``, masked rows are
    sampled too but their cotangents are not added back into the plane (for
    callers whose masked rows reach nothing: ``ops/scatter.gather_cells``)."""
    b, h, w, c = plane.shape
    flat = plane.reshape(b, h * w, c)

    def take(yi, xi):
        return gather_cells(flat, yi * w + xi, mask)

    x0, y0, x1, y1, wx, wy = _corners(coords, h, w)
    top = take(y0, x0) * (1 - wx) + take(y0, x1) * wx
    bot = take(y1, x0) * (1 - wx) + take(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _corner_weights(coords: torch.Tensor, h: int, w: int):
    """The four corners (y, x) of each point's sample and their weights, in
    the order (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    x0, y0, x1, y1, wx, wy = _corners(coords, h, w)
    return ((y0, x0, (1 - wx) * (1 - wy)), (y0, x1, wx * (1 - wy)),
            (y1, x0, (1 - wx) * wy), (y1, x1, wx * wy))


def bilinear_matrix(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, N, H*W) weights of :func:`grid_sample_2d`: row i holds point i's
    four bilinear weights at its pixels, so ``bilinear_matrix(xy, H, W) @
    plane.reshape(B, H*W, C)`` is the sample, and the transposed product its
    adjoint, both as dense products in a fixed order. Where two of a point's
    corners share a pixel (the clamp at the last pixel), one of their weights
    is exactly 0, so the one add that can collide adds a zero."""
    b, n, _ = coords.shape
    corners = _corner_weights(coords, h, w)
    idx = torch.stack([yi * w + xi for yi, xi, _ in corners], -1).long()
    wts = torch.cat([wgt for _, _, wgt in corners], -1)
    out = torch.zeros(b, n, h * w, device=coords.device, dtype=coords.dtype)
    return out.scatter_add_(2, idx, wts)


def grid_sample_2d_cut(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The bilinear sample as the fused level kernel takes it in bf16
    (JAX ops/pallas/level_kernel.py:234-245): each corner's weight cut to
    the plane's dtype, the four exact products summed in float32 in corner
    order, the sum rounded to the plane's dtype once."""
    b, h, w, c = plane.shape
    flat = plane.reshape(b, h * w, c)
    s = None
    for yi, xi, wgt in _corner_weights(coords, h, w):
        idx = (yi * w + xi).long()[..., None].expand(*yi.shape, c)
        term = torch.gather(flat, 1, idx).float() * wgt.to(plane.dtype).float()
        s = term if s is None else s + term
    return s.to(plane.dtype)


def grid_sample_2d_adjoint(g: torch.Tensor, coords: torch.Tensor, h: int, w: int,
                           cut: torch.dtype | None = None,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The transpose of :func:`grid_sample_2d`: add each point's (B, N, C)
    cotangent into its four pixels of a (B, H, W, C) plane, weighted as the
    sample weighs them; with ``cut``, each weight first cut to that dtype
    (the transpose of :func:`grid_sample_2d_cut`); with a (B, N) ``mask``,
    the rows it keeps only (for cotangents that are zeros at the masked
    rows: ``ops/scatter.py`` says why)."""
    b, n, c = g.shape
    trash = TRASH_ROWS if mask is not None else 0
    out = torch.zeros(b * h * w + trash, c, device=g.device, dtype=g.dtype)
    for yi, xi, wgt in _corner_weights(coords, h, w):
        if cut is not None:
            wgt = wgt.to(cut).to(g.dtype)
        idx = flat_segments(yi * w + xi, mask, h * w)
        index_add_rows(out, idx, (g * wgt).reshape(b * n, c))
    return out[: b * h * w].reshape(b, h, w, c)
