"""One fused ALTO level round trip (sample -> MLP -> scatter) and its backward.

Counterpart of ``tomosar2height_tpu/ops/pallas/level_kernel.py``. K4
replaces ``_level_kernel`` (level_kernel.py:110, launched by
``_fused_level_impl``) with two launches: ``csrc/level.cu`` (in bf16
``csrc/level_bf16.cu``) bilinear-samples the plane at each point (border
clamp, align_corners=True), runs ``fc_comm`` (Linear(F,2F) -> ReLU ->
Linear(2F,F)) plus the ``fc_c`` skip from the previous level's point
features and zeros the padding rows (c_out);
then ``csrc/pool2.cu``'s run scatter (``pool2_kernel.scatter_runs_masked``)
writes the masked scatter-mean of c_out into the plane at this level's
resolution (cell = finest Morton id >> 2*level), each cell once from its
run's row-order sum, with the counts. No atomics: K4 is bit-equal run to
run.

The kernels read only the points, cell ids and mask; the TPU's chunk
metadata, lane padding and empty-tile mask have no use here (empty cells
come out 0 by construction). What bounds them on the H100 and how the
designs answer it is noted in the CUDA sources. A CPU tensor takes
:func:`fused_level_plain` (the counterpart of ``_level_ref``,
level_kernel.py:494), a CUDA tensor the kernels; there is no fallback.

**Contract on the card**: the fused2 aligned layout, the only one K4 is
called on (``models/alto.py``, reso >= 32). Each coarse cell's valid rows
form one run (a cell of at most 8 x 8 finest cells lies inside one
1024-cell tile, whose pads fall only at its end), as the run scatter needs;
each finest cell's rows are contiguous and a row's finest cell is
trunc(xy * finest) up to one cell, as K5's d_plane pass needs
(``tests/test_torch_level_runs.py`` holds both). Other row orders are the
plain version's.

:func:`fused_level` is a ``torch.autograd.Function`` (the counterpart of the
JAX custom_vjp, level_kernel.py:605-664) differentiable in the plane, c_last
and the six weights. Its backward is K5 (``csrc/level_bwd.cu``, replacing
``_level_bwd_kernel``, level_bwd_kernel.py:68): a row pass
(:func:`fused_level_bwd_rows`), the d_plane pass (:func:`level_d_plane`: the
bilinear transpose of the rows' d_s, gathered by its pixels in a fixed
order) and three weight-gradient reductions (:func:`level_bwd_reduce`, the
kernel's ``dwi_ref += ...`` sums, :260-279), all bit-equal run to run; or on
the CPU :func:`fused_level_bwd_plain`, which writes K5's math out in torch.

**bf16** (``model.dtype=bfloat16``): plane, c_last and the six weights all
bf16 (xy f32) launch the bf16 instances (``t2h_*_bf16``, counted under
``<name>_bf16``), with the JAX kernels' rounding points, which the plain
versions write out in torch (:func:`mm`: a product of bf16 operands summed
in f32 and rounded once):

- K4 (level_kernel.py:234-258): the bilinear weights cut to bf16, the
  sample summed in f32 and rounded; h = relu(bf16(s W_in) + b_in); o =
  bf16(h W_out) + b_out, then + bf16(c_last W_c), then + b_c, each add
  rounded; c_out bf16; the plane the f32 run mean of c_out rounded once.
  Its kernel is ``csrc/level_bf16.cu``: wgmma fed by the TMA, 128 rows a
  block (64 at F = 512), its plan ``tile_plan.level_plan``; F and Fl are
  padded with zero columns to multiples of 8 for its TMA where they are not
  (the padding changes no sum and is sliced off).
- K5 (level_bwd_kernel.py:206-256): s and pre recomputed as K4's, the relu
  gate from pre; g_pt = bf16(g_plane / count) gathered; d_o = bf16(g_c +
  g_pt); d_h = bf16(d_o W_out^T) gated; d_s = bf16(d_h W_in^T); d_c_last =
  bf16(d_o W_c^T); the weight sums in f32, cast to bf16 once
  (level_kernel.py:653-659). Its row pass is ``csrc/level_bwd_bf16.cu``:
  wgmma fed by the TMA, 128 rows a block (64 at F = 512), W_in read once a
  block for both of its products, its plan ``tile_plan.level_bwd_plan``; F
  and Fl padded as K4's. The d_plane pass takes the same cut weights
  and rounds each pixel's f32 sum once, where JAX rounds each tile's halo
  window and folds the windows in bf16 (level_bwd_kernel.py:385-403): a
  deliberate difference, held to JAX's own bf16 gate
  (tests/test_torch_bf16_sorted.py).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tomosar2height_tpu_torch.ops.cuda import runtime, tile_plan
from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import (
    VALUE_DTYPES,
    acc_dtype,
    pool_gather_plain,
    scatter_runs_masked,
)
from tomosar2height_tpu_torch.ops.sampling import (
    grid_sample_2d,
    grid_sample_2d_adjoint,
    grid_sample_2d_cut,
)
from tomosar2height_tpu_torch.ops.scatter import segment_counts, segment_mean
from tomosar2height_tpu_torch.ops.sorted_scatter import morton_to_plane, plane_to_morton


def level_shift(reso: int, finest: int) -> int:
    """Bits to drop from a finest Morton id to get this level's cell id."""
    return 2 * (int(finest).bit_length() - int(reso).bit_length())


def mm(a, b):
    """a @ b in a's dtype; bf16 operands multiply exactly and sum in f32, the
    sum rounded once (a JAX dot with f32 accumulation, cast to the dtype)."""
    return (acc_dtype(a) @ acc_dtype(b)).to(a.dtype)


def level_sample(plane, xy):
    """K4's bilinear sample of the (B, R, R, F) plane: ``grid_sample_2d``,
    or in bf16 its weights cut to bf16 (``grid_sample_2d_cut``)."""
    if plane.dtype == torch.bfloat16:
        return grid_sample_2d_cut(plane, xy)
    return grid_sample_2d(plane, xy)


def fused_level_plain(plane, c_last, weights, xy, cells, mask, reso: int,
                      finest: int):
    """The level round trip as plain torch ops. Same arguments and returns as
    :func:`fused_level`; in bf16 with its rounding points (module
    docstring)."""
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    h = torch.relu(mm(level_sample(plane, xy), w_in) + b_in)
    o = mm(h, w_out) + b_out
    o = o + mm(c_last, w_c) + b_c
    ncell = reso * reso
    cell_r = cells >> level_shift(reso, finest)
    valid = mask & (cells >= 0) & (cell_r < ncell)
    idx = torch.where(valid, cell_r, torch.zeros_like(cell_r))
    counts = segment_counts(idx, ncell, valid)
    vec = segment_mean(acc_dtype(o), idx, ncell, valid, counts=counts).to(o.dtype)
    plane_out = morton_to_plane(vec, reso)
    c_out = torch.where(mask[..., None], o, torch.zeros_like(o))
    counts = morton_to_plane(counts, reso)[..., 0].to(torch.int32)
    return plane_out, c_out, counts


def fused_level_bwd_rows_plain(plane, c_last, weights, xy, cells, mask, counts, g_plane,
                               g_c, reso: int, finest: int):
    """K5's row pass in plain torch. Same arguments and returns as
    :func:`fused_level_bwd_rows`."""
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    s = level_sample(plane, xy)
    pre = mm(s, w_in) + b_in
    h = torch.relu(pre)
    cell_r = cells >> level_shift(reso, finest)
    g = acc_dtype(g_plane)
    scaled = plane_to_morton((g / counts.clamp_min(1).to(g.dtype)[..., None]).to(g_plane.dtype))
    g_pt = pool_gather_plain(scaled, cell_r, mask & (cells >= 0))
    d_o = torch.where(mask[..., None], g_c + g_pt, torch.zeros_like(g_c))
    d_h = mm(d_o, w_out.t()) * (pre > 0)
    d_s = mm(d_h, w_in.t())
    d_c_last = mm(d_o, w_c.t())

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    return d_c_last, rows(s), rows(h), rows(d_o), rows(d_h), rows(d_s)


def level_d_plane_plain(d_s, xy, cells, mask, reso: int, finest: int, out_dtype=None):
    """K5's d_plane in plain torch. Same arguments and returns as
    :func:`level_d_plane`; in bf16 the weights cut as K4's and each pixel's
    f32 sum rounded once (an f32 ``d_s`` into a bf16 ``out_dtype``: the
    weights uncut, the f32 sum rounded once)."""
    d_s = torch.where(mask[..., None], d_s, torch.zeros_like(d_s))
    cut = d_s.dtype if d_s.dtype == torch.bfloat16 else None
    return grid_sample_2d_adjoint(acc_dtype(d_s), xy, reso, reso, cut, mask).to(
        out_dtype or d_s.dtype)


def fused_level_bwd_plain(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c,
                          reso: int, finest: int):
    """K5's math in plain torch: the cotangents of :func:`fused_level` w.r.t.
    (plane, c_last, weights) for the output cotangents (g_plane, g_c), with
    the forward's counts. Same returns as :func:`fused_level_bwd`."""
    d_c_last, s, h, d_o, d_h, d_s = fused_level_bwd_rows_plain(
        plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c, reso, finest)
    d_plane = level_d_plane_plain(d_s.reshape(g_c.shape), xy, cells, mask, reso, finest)
    dw_in, db_in = level_bwd_reduce_plain(s, d_h, True)
    dw_out, db_out = level_bwd_reduce_plain(h, d_o, True)
    dw_c, _ = level_bwd_reduce_plain(c_last.reshape(-1, c_last.shape[-1]), d_o, False)
    return d_plane, d_c_last, (dw_in, db_in, dw_out, db_out, dw_c, db_out.clone())


def level_bwd_reduce_plain(a, b, bias: bool):
    """(a^T b, colsum(b) if ``bias`` else None) over the rows of (M, K) a and
    (M, N) b; bf16 ones summed in f32 and rounded once."""
    return mm(a.t(), b), (acc_dtype(b).sum(0).to(b.dtype) if bias else None)


def _splits(m: int, k: int, n: int, device: torch.device) -> int:
    """Row splits of K5's f32 weight-gradient reduction: two blocks an SM
    over the output's tiles (two waves of its one block an SM; the kernel
    picks the tile), at most one per 512 rows."""
    tiles = runtime.library().t2h_level_bwd_reduce_tiles(k, n)
    return max(1, min(2 * _sm_count(device.index) // tiles, -(-m // 512)))


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tma_rows(t):
    """t as the bf16 weight sums' TMA takes it: zero columns up to a multiple
    of 8 and a 16-byte aligned start (a copy only where t lacks either)."""
    pad = -t.shape[1] % 8
    if pad == 0 and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, pad))


def level_bwd_reduce(a, b, bias: bool):
    """K5's second kernel, one weight gradient: the same returns as
    :func:`level_bwd_reduce_plain`. f32 a and b: a hand-written split-K
    reduction over the rows on the tensor cores at fp32 accuracy (3xTF32;
    ``csrc/level_bwd.cu`` ``t2h_level_bwd_reduce``); bf16: TMA-fed wgmma
    into f32 sums, dw and db rounded to bf16 once (``csrc/reduce_bf16.cu``,
    its splits and scratch from ``tile_plan``; widths not a multiple of 8
    are zero-padded for its TMA, the padding sliced off). Deterministic:
    the splits are summed in a fixed order."""
    if runtime.on_cpu(a):
        return level_bwd_reduce_plain(a, b, bias)
    dev, dt = a.device, a.dtype
    m, k = a.shape
    n = b.shape[1]
    _check_dtype(dt)
    runtime.require(a, "a", dt, (m, k), dev)
    runtime.require(b, "b", dt, (m, n), dev)
    if dt == torch.bfloat16:
        a, b = _tma_rows(a), _tma_rows(b)
        kp, np_ = a.shape[1], b.shape[1]
        if runtime.library().t2h_level_bwd_reduce_tiles_bf16(kp, np_) != math.prod(
                tile_plan.reduce_grid(kp, np_)):
            raise RuntimeError("tile_plan.reduce_grid disagrees with csrc/reduce_bf16.cu")
        splits = tile_plan.reduce_splits(m, kp, np_, _sm_count(dev.index))
        rows = tile_plan.reduce_part_rows(kp, np_, bias)
    else:
        kp, np_ = k, n
        splits = _splits(m, k, n, dev)
        rows = k + bias
    part = torch.empty(splits * rows * np_, device=dev, dtype=torch.float32)
    dw = torch.empty((kp, np_), device=dev, dtype=dt)
    db = torch.empty(np_, device=dev, dtype=dt) if bias else None
    err = runtime.entry("level_bwd_reduce", dt)(
        a.data_ptr(), b.data_ptr(), m, kp, np_, splits, part.data_ptr(), dw.data_ptr(),
        db.data_ptr() if bias else None, runtime.stream_ptr(dev))
    runtime.check(err, "level_bwd_reduce")
    runtime.launched("level_bwd_reduce", dt)
    if (kp, np_) != (k, n):
        dw, db = dw[:k, :n].contiguous(), (db[:n].contiguous() if bias else None)
    return dw, db


def fused_level_bwd_rows(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c,
                         reso: int, finest: int):
    """K5's row pass (``t2h_fused_level_bwd``): d_c_last and the rows the
    weight gradients and the d_plane pass need. In f32 on the tensor cores
    at fp32 accuracy (3xTF32 ``mma.sync``, ``csrc/level_bwd.cu``), 64 rows a
    block; in bf16 on ``wgmma`` fed by the TMA (``csrc/level_bwd_bf16.cu``),
    128 rows a block (64 at F = 512), its plan ``tile_plan.level_bwd_plan``
    (checked against the C side's), F and Fl padded with zero columns to
    multiples of 8 for its TMA where they are not (sliced off again).

    Args: the forward's inputs, its counts (B, R, R) int32, and the output
    cotangents g_plane (B, R, R, F), g_c (B, N, F), all in the plane's dtype
    (f32 or bf16) and contiguous.

    Returns:
        d_c_last (B, N, Fl), and the rows (M = B*N): s (M, F) the recomputed
        sample, h (M, 2F), d_o (M, F), d_h (M, 2F), d_s (M, F) the sample's
        cotangent. Padding rows weigh 0 in every gradient (d_o, d_h and d_s
        are 0 there); the kernel's s is 0 there too, the plain version
        samples them.

    Takes F <= 512 and any Fl: neither kernel's shared memory grows with Fl
    (f32: 219 KB at F = 512; bf16: 217 KB at F = 256 and 512). Allocates
    the 7F values a row of those rows: ~2.3 GB at the flagship's F=512
    level in f32. Each output element is written once; every output in the
    plane's dtype.
    """
    if runtime.on_cpu(plane):
        return fused_level_bwd_rows_plain(plane, c_last, weights, xy, cells, mask, counts,
                                          g_plane, g_c, reso, finest)
    dev, dt = plane.device, plane.dtype
    b, r, _, f = plane.shape
    n, fl = c_last.shape[1], c_last.shape[-1]
    _check_level(plane, c_last, weights, xy, cells, mask, reso)
    runtime.require(counts, "counts", torch.int32, (b, r, r), dev)
    runtime.require(g_plane, "g_plane", dt, (b, r, r, f), dev)
    runtime.require(g_c, "g_c", dt, (b, n, f), dev)
    w_in, b_in, w_out, _, w_c, _ = weights
    if dt == torch.bfloat16:
        plane, g_plane, g_c, w_in, b_in, w_out_t, w_c_t = _tma_rows_pass(
            plane, g_plane, g_c, weights)
        fk, flk = plane.shape[-1], w_c_t.shape[1]
        _bwd_plan(fk, flk)
        w_in_t = None  # not read: the kernel reads W_in's boxes both ways
    else:
        fk, flk = f, fl
        w_out_t, w_c_t, w_in_t = (w.t().contiguous() for w in (w_out, w_c, w_in))
    m = b * n
    new = lambda *shape: torch.empty(shape, device=dev, dtype=dt)  # noqa: E731
    d_c_last = new(b, n, flk)
    s, hs, d_o, d_h, d_s = new(m, fk), new(m, 2 * fk), new(m, fk), new(m, 2 * fk), new(m, fk)
    err = runtime.entry("fused_level_bwd", dt)(
        plane.data_ptr(), xy.data_ptr(), cells.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), g_plane.data_ptr(), g_c.data_ptr(), w_in.data_ptr(),
        b_in.data_ptr(), w_out_t.data_ptr(), w_c_t.data_ptr(),
        None if w_in_t is None else w_in_t.data_ptr(),
        d_c_last.data_ptr(), s.data_ptr(), hs.data_ptr(), d_o.data_ptr(), d_h.data_ptr(),
        d_s.data_ptr(), b, n, r, fk, flk, level_shift(reso, finest), runtime.stream_ptr(dev))
    runtime.check(err, "fused_level_bwd")
    runtime.launched("fused_level_bwd", dt)
    if (fk, flk) != (f, fl):
        d_c_last = d_c_last[..., :fl].contiguous()
        s, hs, d_o, d_h, d_s = (x[:, :w].contiguous() for x, w in (
            (s, f), (hs, 2 * f), (d_o, f), (d_h, 2 * f), (d_s, f)))
    return d_c_last, s, hs, d_o, d_h, d_s


def _tma_rows_pass(plane, g_plane, g_c, weights):
    """K5 bf16's row-pass operands as its TMA and 16-byte loads take them:
    (plane, g_plane, g_c, w_in, b_in, w_out^T, w_c^T) with F and Fl padded
    with zero columns to multiples of 8 (w_in's hidden columns and w_out's
    rows with them, at the end) and 16-byte aligned (a copy only where
    needed). Zero columns add nothing to any sum and open no gate."""
    f, fl = plane.shape[-1], weights[4].shape[0]
    pf, pl = -f % 8, -fl % 8
    w_in, b_in, w_out, _, w_c, _ = weights
    return (_tma_ready(plane, (0, pf)), _tma_ready(g_plane, (0, pf)),
            _tma_ready(g_c, (0, pf)), _tma_ready(w_in, (0, 2 * pf, 0, pf)),
            _tma_ready(b_in, (0, 2 * pf)), _tma_ready(w_out, (0, pf, 0, 2 * pf)).t().contiguous(),
            _tma_ready(w_c, (0, pf, 0, pl)).t().contiguous())


@functools.lru_cache(maxsize=None)
def _bwd_plan(f: int, fl: int) -> dict:
    """``tile_plan.level_bwd_plan(f, fl)``, once held equal to the plan the
    C side computes (``t2h_level_bwd_plan_bf16``)."""
    return _c_plan(tile_plan.level_bwd_plan(f, fl), tile_plan.LEVEL_BWD_PLAN_KEYS,
                   runtime.library().t2h_level_bwd_plan_bf16, f, fl)


@functools.lru_cache(maxsize=None)
def _d_plane_plan(r: int, f: int, fr: int, elem: int) -> dict:
    """``tile_plan.d_plane_plan``, once held equal to the C side's
    (``t2h_level_d_plane_plan``)."""
    return _c_plan(tile_plan.d_plane_plan(r, f, fr, elem), tile_plan.D_PLANE_PLAN_KEYS,
                   runtime.library().t2h_level_d_plane_plan, r, f, fr, elem)


def _c_plan(plan: dict, keys, fn, *args) -> dict:
    out = (ctypes.c_int * len(keys))()
    runtime.check(fn(*args, ctypes.addressof(out)), fn.__name__)
    want = tuple(int(plan[k]) for k in keys)
    if tuple(out) != want:
        raise RuntimeError(f"{fn.__name__}{args}: the C side plans {tuple(out)}, "
                           f"tile_plan {want} ({', '.join(keys)})")
    return plan


def level_d_plane(d_s, xy, cells, mask, reso: int, finest: int, out_dtype=None):
    """K5's d_plane pass (``t2h_level_d_plane``): the bilinear transpose of the
    rows' sample cotangents, d_plane[b, y, x] = sum over the valid rows whose
    sample reads pixel (x, y) of its weight times d_s, each pixel written
    once from one fixed-order sum (bit-equal run to run): a block a tile of
    pixels and a chunk of features (``tile_plan.d_plane_plan``, checked
    against the C side's), each row's d_s line read once a block.

    Args:
        d_s: (B, N, F) f32 or bf16 the rows' d_s (:func:`fused_level_bwd_rows`).
        xy, cells, mask: the forward's (B, N, 2) f32, (B, N) int32 finest
            Morton ids at ``finest``, (B, N) bool.
        reso: the plane's resolution R; finest: the layout's.
        out_dtype: d_plane's dtype, d_s's by default; bfloat16 for an f32
            d_s is the backward of a bf16 plane's f32 sample
            (``ops.fused.sorted_sample``: ``t2h_level_d_plane_wide_bf16``,
            counted under ``level_d_plane_wide_bf16``).

    Returns d_plane (B, R, R, F) in ``out_dtype`` (a bf16 d_s: the weights
    cut as K4's, each pixel's f32 sum rounded once; an f32 d_s into bf16:
    the weights uncut, the f32 sum rounded once). On the card the rows of
    each finest cell must be contiguous and a row's cell within one cell of
    trunc(xy * finest), as on the aligned layout (the module's contract).
    """
    if runtime.on_cpu(d_s):
        return level_d_plane_plain(d_s, xy, cells, mask, reso, finest, out_dtype)
    dev, dt = d_s.device, d_s.dtype
    out_dtype = out_dtype or dt
    b, n, f = d_s.shape
    _check_dtype(dt)
    wide = out_dtype != dt
    if wide and (dt, out_dtype) != (torch.float32, torch.bfloat16):
        raise TypeError(f"d_plane pass from {dt} into {out_dtype}: only float32 into "
                        "bfloat16 besides a dtype into itself")
    runtime.require(d_s, "d_s", dt, (b, n, f), dev)
    runtime.require(xy, "xy", torch.float32, (b, n, 2), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    if finest < reso:
        raise ValueError(f"finest resolution {finest} < reso {reso}")
    _d_plane_plan(reso, f, finest, d_s.element_size())
    d_plane = torch.empty((b, reso, reso, f), device=dev, dtype=out_dtype)
    offs = torch.empty(2 * b * finest * finest, device=dev, dtype=torch.int32)
    fn = (runtime.entry("level_d_plane_wide", out_dtype) if wide
          else runtime.entry("level_d_plane", dt))
    err = fn(d_s.data_ptr(), xy.data_ptr(), cells.data_ptr(), mask.data_ptr(),
             offs.data_ptr(), d_plane.data_ptr(), b, n, reso, f, finest,
             runtime.stream_ptr(dev))
    runtime.check(err, "level_d_plane")
    if wide:
        runtime.launched("level_d_plane_wide", out_dtype)
    else:
        runtime.launched("level_d_plane", dt)
    return d_plane


def fused_level_bwd(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c,
                    reso: int, finest: int):
    """K5: the backward of :func:`fused_level`. One row pass
    (:func:`fused_level_bwd_rows`: d_c_last and the rows), the d_plane pass
    (:func:`level_d_plane`), then three :func:`level_bwd_reduce` calls.

    Args: the forward's inputs, its counts (B, R, R) int32, and the output
    cotangents g_plane (B, R, R, F), g_c (B, N, F), all in the plane's dtype
    and contiguous.

    Returns:
        d_plane (B, R, R, F), d_c_last (B, N, Fl), and the weight cotangents
        (dw_in, db_in, dw_out, db_out, dw_c, db_c), db_c equal to db_out
        (both biases add into o).

    The row pass's 7F values of scratch a row (B*N rows), ~2.3 GB at the
    flagship's F=512 level in f32, are freed on return, d_s (F of them)
    before the reductions. Every cotangent comes in its input's dtype.
    """
    if runtime.on_cpu(plane):
        return fused_level_bwd_plain(plane, c_last, weights, xy, cells, mask, counts,
                                     g_plane, g_c, reso, finest)
    d_c_last, s, hs, d_o, d_h, d_s = fused_level_bwd_rows(
        plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c, reso, finest)
    d_plane = level_d_plane(d_s.view(g_c.shape), xy, cells, mask, reso, finest)
    del d_s
    dw_in, db_in = level_bwd_reduce(s, d_h, True)
    dw_out, db_out = level_bwd_reduce(hs, d_o, True)
    dw_c, _ = level_bwd_reduce(c_last.reshape(-1, c_last.shape[-1]), d_o, False)
    return d_plane, d_c_last, (dw_in, db_in, dw_out, db_out, dw_c, db_out.clone())


class _FusedLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, c_last, xy, cells, mask, reso: int, finest: int, *weights):
        plane_out, c_out, counts = _fused_level(plane, c_last, weights, xy, cells, mask,
                                                reso, finest)
        ctx.mark_non_differentiable(counts)
        # save_for_backward (not ctx attributes): non-reentrant checkpointing
        # drops these and recomputes them in the backward
        ctx.save_for_backward(plane, c_last, xy, cells, mask, counts, *weights)
        ctx.reso, ctx.finest = reso, finest
        return plane_out, c_out, counts

    @staticmethod
    def backward(ctx, g_plane, g_c, _g_counts):
        plane, c_last, xy, cells, mask, counts, *weights = ctx.saved_tensors
        d_plane, d_c_last, dw = fused_level_bwd(
            plane, c_last, tuple(weights), xy, cells, mask, counts,
            g_plane.contiguous(), g_c.contiguous(), ctx.reso, ctx.finest)
        return (d_plane, d_c_last, None, None, None, None, None, *dw)


def fused_level(plane, c_last, weights, xy, cells, mask, reso: int, finest: int):
    """K4: one ALTO level round trip on the Morton-aligned layout;
    differentiable in plane, c_last and weights (backward: K5,
    :func:`fused_level_bwd`).

    Args:
        plane: (B, R, R, F) NHWC plane (post-convs), R == ``reso``; f32 or
            bf16 (the bf16 rule: module docstring).
        c_last: (B, N, Fl) previous level's point features, in plane's dtype.
        weights: (w_in (F, 2F), b_in (2F,), w_out (2F, F), b_out (F,),
            w_c (Fl, F), b_c (F,)), in plane's dtype, row-major (in, out).
        xy: (B, N, 2) f32 point coordinates in [0, 1].
        cells: (B, N) int32 finest Morton ids (PAD_CELL_SENTINEL on pads).
        mask: (B, N) bool validity.
        reso: this level's plane resolution; finest: the layout's.

    Returns:
        plane_out (B, R, R, F) scatter-mean of the new point features (empty
        cells 0), c_out (B, N, F) new point features (0 on masked rows),
        both in plane's dtype, counts (B, R, R) int32 points per cell.

    K4 runs its three products on the tensor cores: in f32 at fp32 accuracy
    (3xTF32 ``mma.sync``, ``csrc/mma_tf32x3.cuh``), 64 points a block; in
    bf16 on ``wgmma`` fed by the TMA (``csrc/level_bf16.cu``), 128 points a
    block (64 at F = 512). It takes F <= 512 and any Fl (c_last is
    contracted in K-chunks, so Fl = 1024 at the first up level of a depth-6
    U-Net fits); a wider F raises. K5 takes the same F and Fl. On the card
    the rows must follow the aligned layout (the module's contract).
    """
    return _FusedLevel.apply(plane, c_last, xy, cells, mask, reso, finest, *weights)


def _check_dtype(dt: torch.dtype) -> None:
    if dt not in VALUE_DTYPES:
        raise TypeError(f"dtype {dt}: the level kernels take float32 or bfloat16")


def _check_level(plane, c_last, weights, xy, cells, mask, reso: int) -> None:
    dev, dt = plane.device, plane.dtype
    b, r, _, f = plane.shape
    if r != reso:
        raise ValueError(f"plane resolution {r} != reso {reso}")
    _check_dtype(dt)
    n, fl = c_last.shape[1], c_last.shape[-1]
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    runtime.require(plane, "plane", dt, (b, r, r, f), dev)
    runtime.require(c_last, "c_last", dt, (b, n, fl), dev)
    runtime.require(xy, "xy", torch.float32, (b, n, 2), dev)
    runtime.require(cells, "cells", torch.int32, (b, n), dev)
    runtime.require(mask, "mask", torch.bool, (b, n), dev)
    runtime.require(w_in, "w_in", dt, (f, 2 * f), dev)
    runtime.require(b_in, "b_in", dt, (2 * f,), dev)
    runtime.require(w_out, "w_out", dt, (2 * f, f), dev)
    runtime.require(b_out, "b_out", dt, (f,), dev)
    runtime.require(w_c, "w_c", dt, (fl, f), dev)
    runtime.require(b_c, "b_c", dt, (f,), dev)


def _tma_level(plane, c_last, weights):
    """K4 bf16's operands as its TMA takes them: F and Fl padded with zero
    columns (and w_in's hidden columns, w_out's rows with them) to multiples
    of 8, and a 16-byte aligned copy of any tensor that is not (a copy only
    where needed). Zero columns add nothing to any sum."""
    f, fl = plane.shape[-1], c_last.shape[-1]
    pf, pl = -f % 8, -fl % 8
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    return (_tma_ready(plane, (0, pf)), _tma_ready(c_last, (0, pl)),
            (_tma_ready(w_in, (0, 2 * pf, 0, pf)), _tma_ready(b_in, (0, 2 * pf)),
             _tma_ready(w_out, (0, pf, 0, 2 * pf)), _tma_ready(b_out, (0, pf)),
             _tma_ready(w_c, (0, pf, 0, pl)), _tma_ready(b_c, (0, pf))))


def _tma_ready(t, pads):
    """t padded with zeros by ``pads`` (``F.pad``'s order), or, with no
    padding, t itself if 16-byte aligned, else an aligned copy."""
    if any(pads):
        return torch.nn.functional.pad(t, pads)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fused_level(plane, c_last, weights, xy, cells, mask, reso: int, finest: int):
    if runtime.on_cpu(plane):
        return fused_level_plain(plane, c_last, weights, xy, cells, mask, reso,
                                 finest)
    _check_level(plane, c_last, weights, xy, cells, mask, reso)
    dev, dt = plane.device, plane.dtype
    b, r, _, f = plane.shape
    if dt == torch.bfloat16:
        plane, c_last, weights = _tma_level(plane, c_last, weights)
    fk = plane.shape[-1]
    n, fl = c_last.shape[1], c_last.shape[-1]
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    c_out = torch.empty((b, n, fk), device=dev, dtype=dt)
    err = runtime.entry("fused_level", dt)(
        plane.data_ptr(), c_last.data_ptr(), xy.data_ptr(), mask.data_ptr(),
        w_in.data_ptr(), b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        w_c.data_ptr(), b_c.data_ptr(), c_out.data_ptr(), b, n, r, fk, fl,
        runtime.stream_ptr(dev))
    runtime.check(err, "fused_level")
    runtime.launched("fused_level", dt)
    if fk != f:
        c_out = c_out[..., :f].contiguous()
    plane_out, counts = scatter_runs_masked(c_out, cells, mask, reso,
                                            level_shift(reso, finest))
    runtime.launched("fused_level_scatter", dt)
    return plane_out, c_out, counts
