"""Bilinear sample of a plane at Morton-aligned points: K9.

Counterpart of ``tomosar2height_tpu/ops/pallas/gather_kernel.py``. The CUDA
kernel K9 (``csrc/tile_gather.cu`` ``t2h_tile_gather``) replaces
``_gather_kernel`` (gather_kernel.py:69, launched by ``_tile_gather_impl``,
``pallas_tile_gather``): grid_sample with the border clamp and
align_corners=True (``ops/sampling.py``) at every row of the tiles' ranges.
The TPU kernel's lane-packed coordinate rows (``make_aux``) and tile windows
exist for the MXU and Mosaic; the kernel here reads the (B, N, 2) coordinates
and only the last tile offset. Rows past the last tile's range come out 0
(the TPU kernel leaves them undefined); pad rows inside the ranges are
sampled and left for the caller's mask
(:func:`tomosar2height_tpu_torch.ops.fused.tile_gather`). A CPU tensor takes
:func:`tile_gather_plain`, a CUDA tensor the kernel; there is no fallback.

A bf16 plane (the model's bf16 dtype) takes the kernel's bf16 instance
(``t2h_tile_gather_bf16``, counted under ``tile_gather_bf16``) and the JAX
kernel's rule with a bf16 plane (gather_kernel.py:174-186): the four
bilinear weights cut to bf16, the exact products summed in f32, each sample
rounded to bf16 once, the output bf16 (``grid_sample_2d_cut``, which the
plain version runs); the coordinates stay f32.

Its backward (:func:`tile_gather_bwd`, the JAX ``_tile_gather_bwd``,
``ops/pallas/fused.py:65``: grid_sample's vjp of the masked cotangent into
the plane) is K5's d_plane pass (``csrc/level_bwd.cu``
``t2h_level_d_plane``, :func:`~tomosar2height_tpu_torch.ops.cuda.level_kernel.level_d_plane`):
a mark pass writes each finest cell's row range, then a warp a (pixel,
feature chunk) adds the rows of its rectangle of finest cells in a fixed
order, each pixel written once. Its contract holds on the fused layout as on
fused2's: each finest cell's rows are contiguous (Morton-sorted inside each
256-cell tile, pads with the sentinel id only at tile ends, which the mark
pass skips). In bf16 the cotangent is bf16 and the pass takes its bf16
instance: the transpose of the cut weights, each pixel's f32 sum rounded to
bf16 once. JAX's ``_tile_gather_bwd`` samples at coordinates rounded to bf16
(``xy.astype(p.dtype)``), so its bf16 backward is not the transpose of its
forward; the port keeps the f32 coordinates of the forward (a deliberate
difference, held to JAX's bf16 gate by ``tests/test_torch_bf16_tiles.py``).
"""

from __future__ import annotations

import torch

from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import value_dtype
from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d, grid_sample_2d_cut


def _past_last_tile(tile_offsets, n: int) -> torch.Tensor:
    """(B, N) bool: rows at or past each entry's last tile offset."""
    rows = torch.arange(n, device=tile_offsets.device)
    return rows[None, :] >= tile_offsets[:, -1:].long()


def tile_gather_plain(plane, xy, tile_offsets) -> torch.Tensor:
    """K9's function: (B, R, R, F) plane, (B, N, 2) xy in [0, 1], (B, T + 1)
    tile offsets -> (B, N, F) samples in the plane's dtype, 0 past the last
    tile's range; a bf16 plane's with the weights cut (module docstring)."""
    cut = plane.dtype == torch.bfloat16
    out = grid_sample_2d_cut(plane, xy) if cut else grid_sample_2d(plane, xy)
    past = _past_last_tile(tile_offsets, xy.shape[1])
    return torch.where(past[..., None], torch.zeros_like(out), out)


def tile_gather(plane, xy, tile_offsets) -> torch.Tensor:
    """K9: the same arguments and return as :func:`tile_gather_plain`; on a
    CUDA tensor plane is (B, R, R, F) f32 or bf16, xy (B, N, 2) f32 and
    tile_offsets (B, R*R/256 + 1) int32 at this resolution, all contiguous.
    Not differentiable itself: the model calls it through
    ``ops.fused.tile_gather``."""
    if runtime.on_cpu(plane):
        return tile_gather_plain(plane, xy, tile_offsets)
    dev, dt = plane.device, value_dtype("plane", plane)
    b, r, _, f = plane.shape
    n = xy.shape[1]
    t = tile_offsets.shape[1] - 1
    runtime.require(plane, "plane", dt, (b, r, r, f), dev)
    runtime.require(xy, "xy", torch.float32, (b, n, 2), dev)
    runtime.require(tile_offsets, "tile_offsets", torch.int32, (b, t + 1), dev)
    out = torch.empty((b, n, f), device=dev, dtype=dt)
    err = runtime.entry("tile_gather", dt)(
        plane.data_ptr(), xy.data_ptr(), tile_offsets.data_ptr(), out.data_ptr(), b, n, r,
        f, t, runtime.stream_ptr(dev))
    runtime.check(err, "tile_gather")
    runtime.launched("tile_gather", dt)
    return out


def tile_gather_bwd(g, xy, cells, mask, reso: int, finest: int) -> torch.Tensor:
    """K9's backward: the cotangent (B, R, R, F) of the plane for the
    samples' cotangent ``g`` (B, N, F, in the plane's dtype), the masked
    rows' ignored; xy (B, N, 2) f32 and cells (B, N) int32 finest Morton ids
    at ``finest`` as K9's layout holds them. One K5 d_plane pass on a card
    (``level_d_plane`` and ``tile_gather_bwd``, each ``_bf16`` on a bf16
    ``g``: the transpose of K9's cut weights); on the CPU the plain transpose
    (``level_d_plane_plain``)."""
    d_plane = lk.level_d_plane(g, xy, cells, mask, reso, finest)
    if not runtime.on_cpu(g):
        runtime.launched("tile_gather_bwd", g.dtype)
    return d_plane
