"""The host plans of the bf16 kernels on the TMA and wgmma and of K5's
d_plane pass (``ops/cuda/tile_plan.py``, mirrored by ``csrc/reduce_bf16.cu``,
``csrc/conv_bf16.cu``, ``csrc/level_bf16.cu``, ``csrc/level_bwd_bf16.cu``
and ``csrc/level_bwd.cu``), emulated in numpy on the CPU (the sums in
float64, the convs and the d_plane folds in float32):

- K5's bf16 weight sums at every reduction of the flagship's eight levels
  (``chip_smoke.LEVEL_SHAPES``) and at ragged widths: each block's tile and
  row split, streamed in stages with zeros past M, Ka and Nb, its share of
  the bias sums (the stages s % ny == y), then the splits' partial tiles and
  bias rows added. Every output element is covered once a split, every row
  once; the sums equal ``level_bwd_reduce_plain``'s.
- K8 in bf16 at every conv shape of a fusion forward (``chip_smoke.CONVS``)
  at batch 1-2 and reduced widths, and at full width at 16^2 and 32^2: each
  block's rectangle and channel tile, each tap's input box from
  ``tile_plan.tap_origin`` with zeros past the image and past Cin, summed
  over the taps and channel chunks. Every output element is covered once;
  the result equals ``conv3x3_plain``'s. K7's pooled second conv at the
  five pooled pairs of ``chip_smoke.IMAGE_PAIRS`` (batch 1, reduced widths)
  and at ragged shapes: every rectangle of even height and width at even
  origins, each pooled pixel taken once from one rectangle's staged tile,
  equal to the 2x2 max pool of the plain relu(conv).
- K6 in bf16: its plan (``tile_plan.decoder_plan``) at the model's widths
  (``chip_smoke.DECODER``) and at ragged ones: conv1 and conv2 on K8's plan
  by their own routes, conv3 with the head on BN = 64, one block column, so
  that each block owns all of x3's channels for its rectangle; the head
  emulated block by block: x3 from the emulated conv3 rounded to bf16, then
  two threads a pixel over every other 16-byte chunk of x, x1, x2 and x3,
  the halves added, the parts added onto b4 in order, w4's columns ``oc`` a
  pass. Every output covered once; equal to ``conv_decoder_plain``'s.
- K4 in bf16 at every level of ``chip_smoke.LEVEL_SHAPES`` at full width,
  at Fl = 1024 and at ragged widths (a few hundred rows): each block's rows,
  each warpgroup's rows and o columns (split by columns at F = 512), the
  hidden chunks' halves, the W_in stages (their k16 steps cut at F rounded
  to 16), the W_out and c_last stages, o1 parked and c_last W_c added last.
  Every row and output column covered once, every hidden column once a
  row, every K index once a product; c_out equals the plain MLP's.
- K5's bf16 row pass at the flagship's levels (F = 512 cut to 264, which
  keeps the split two-phase plan, and at full width), at Fl = 1024 and at
  ragged widths: each warpgroup's rings taken in order, every row, hidden
  column and output column covered once, every K index once a product;
  d_c_last, h, d_h and d_s equal to the plain row pass's (float64, without
  the bf16 roundings).
- K9 (``csrc/tile_gather.cu``) at the flagship's widths in bf16 and f32, at
  ragged widths and on an unaligned plane: each (row, 16-byte chunk) item of
  each warp's steps, its corner from its row's own lane; every output
  element written once, no chunk past its row, rows past the last tile 0,
  the bf16 samples the plain version's bits (and within a bf16 ulp of the
  JAX kernel in interpret mode), the f32 ones within 1e-6.
- K5's d_plane pass at every R of the flagship's levels (widths cut) and at
  R = 1, 2, 3 and fr = R, in both element sizes, on the aligned layout with
  a crowded corner, masked rows in valid cells and an empty entry: each
  pixel's rows, as its tile's walk meets them, are a walk of its own
  rectangle's rows in the same order (the kernel it replaced sums them so:
  the same bits); every pixel and feature stored once; the float32 folds
  equal the plain transpose.

The card's tests check that the C side takes the same tiles
(``tests/test_torch_cuda.py::TestWgmmaBf16Kernels``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk
from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
from tomosar2height_tpu_torch.ops.cuda import tile_plan as tp

SMS = 132  # the H100's SMs


def _reductions():
    seen = []
    for _, f, fl in cs.LEVEL_SHAPES:
        for shape in ((f, 2 * f, True), (2 * f, f, True), (fl, f, False)):
            if shape not in seen:
                seen.append(shape)
    return seen


def emulate_reduce(a, b, bias: bool, sms: int):
    """(dw, db or None) as the plan computes them: per block (x, y, z) its
    bk x bn tile over its split's stages; returns also the coverage counts
    of the outputs (per split) and of the rows."""
    m, ka = a.shape
    nb = b.shape[1]
    bk, bn = tp.reduce_tile(ka, nb)
    nx, ny = tp.reduce_grid(ka, nb)
    splits = tp.reduce_splits(m, ka, nb, sms)
    rps = tp.reduce_rows_per_split(m, splits)
    rows = tp.reduce_part_rows(ka, nb, bias)
    r = tp.REDUCE_ROWS
    # zeros past M (the TMA's fill) and past Ka, Nb up to whole tiles
    ap = np.zeros((splits * rps, ny * bk))
    bp = np.zeros((splits * rps, nx * bn))
    ap[:m, :ka], bp[:m, :nb] = a, b
    part = np.zeros((splits, rows + ny * bk, nx * bn))
    out_cover = np.zeros((ka, nb), int)
    row_cover = np.zeros(splits * rps, int)
    for z in range(splits):
        m_begin = z * rps
        m_end = min(m, m_begin + rps)
        steps = -(-(m_end - m_begin) // r) if m_end > m_begin else 0
        for y in range(ny):
            for x in range(nx):
                acc = np.zeros((bk, bn))
                bsum = np.zeros(bn)
                for s in range(steps):
                    lo = m_begin + s * r
                    at = ap[lo:lo + r, y * bk:(y + 1) * bk]
                    bt = bp[lo:lo + r, x * bn:(x + 1) * bn]
                    acc += at.T @ bt
                    if bias and s % ny == y:
                        bsum += bt.sum(0)
                    if x == 0 and y == 0:
                        row_cover[lo:lo + r] += 1
                k_hi, n_hi = min(ka, (y + 1) * bk), min(nb, (x + 1) * bn)
                part[z, y * bk:k_hi, x * bn:n_hi] = acc[:k_hi - y * bk, :n_hi - x * bn]
                out_cover[y * bk:k_hi, x * bn:n_hi] += 1
                if bias:
                    part[z, ka + y, x * bn:n_hi] = bsum[:n_hi - x * bn]
    dw = part[:, :ka, :nb].sum(0)
    db = part[:, ka:ka + ny, :nb].sum((0, 1)) if bias else None
    return dw, db, out_cover, row_cover[:m], splits


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("ka,nb,bias", _reductions() + [(40, 72, True), (1032, 200, True)])
def test_reduce_plan_covers_and_sums(ka, nb, bias, sms):
    rng = np.random.default_rng(ka * nb + bias)
    m = 1099 + 64 * (ka % 3)
    a, b = rng.normal(size=(m, ka)), rng.normal(size=(m, nb))
    dw, db, out_cover, row_cover, splits = emulate_reduce(a, b, bias, sms)
    assert (out_cover == splits).all()  # each output in one block of each split
    assert (row_cover == 1).all()  # each row in one split's stage
    assert splits * tp.reduce_rows_per_split(m, splits) >= m
    nx, ny = tp.reduce_grid(ka, nb)
    assert nx * ny * splits <= max(sms, nx * ny)  # about one block an SM, no more
    want_w, want_b = lk.level_bwd_reduce_plain(torch.from_numpy(a), torch.from_numpy(b), bias)
    np.testing.assert_allclose(dw, want_w.numpy(), rtol=1e-12, atol=1e-9)
    if bias:
        np.testing.assert_allclose(db, want_b.numpy(), rtol=1e-12, atol=1e-9)
    else:
        assert db is None and want_b is None


def emulate_conv(x, w, bias, sms: int, pool: bool = False):
    """y = conv3x3(x, w) + bias as the plan computes it: per block its
    rectangle and channel tile, each tap's box at ``tap_origin``, zeros past
    the image and past Cin, summed over the taps and the ck-channel chunks.
    Returns y and the coverage count of each output element; with ``pool``
    (K7's pooled conv: relu, then the 2x2 max pool of each block's staged
    tile) also the pooled output and its coverage counts."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    plan = tp.conv_plan(bsz, h, wd, cin, cout, sms, pool)
    tw, th, ck_, bn = plan["tw"], plan["th"], plan["ck"], plan["bn"]
    blocks = [tp.conv_block(plan, cout, i) for i in range(plan["blocks"])]
    assert len({blk for blk in blocks}) == plan["blocks"]
    # the rectangles, from the first channel tile's blocks
    rect = np.array([blk[:3] for blk in blocks if blk[3] == 0])
    bs, x0, y0 = rect[:, 0], rect[:, 1], rect[:, 2]
    # x with zeros on every side, far enough for every box
    nck = -(-cin // ck_)
    pad_y = plan["tiles_y"] * th + 2 - h
    pad_x = plan["tiles_x"] * tw + 2 - wd
    xp = np.zeros((bsz, h + 1 + pad_y, wd + 1 + pad_x, nck * ck_), np.float32)
    xp[:, 1:h + 1, 1:wd + 1, :cin] = x
    wp = np.zeros((9, nck * ck_, cout), np.float32)
    wp[:, :cin] = w.reshape(9, cin, cout)
    tiles = np.zeros((len(rect), th, tw, cout), np.float32)
    hp, wp_ = xp.shape[1:3]
    pixels = xp.reshape(-1, nck * ck_)
    for tap in range(9):
        ox, oy = tp.tap_origin(x0, y0, tap)
        ys = (oy[:, None] + np.arange(th))[:, :, None] + 1
        xs = (ox[:, None] + np.arange(tw))[:, None, :] + 1
        box = pixels[(bs[:, None, None] * hp + ys) * wp_ + xs]  # (rects, th, tw, nck * ck)
        for c in range(nck):
            sl = slice(c * ck_, (c + 1) * ck_)
            tiles += box[..., sl] @ wp[tap, sl]
    tiles += bias
    if pool:
        tiles = np.maximum(tiles, 0)
    y = np.zeros((bsz, h, wd, cout), np.float32)
    cover = np.zeros((bsz, h, wd, cout), np.int32)
    pooled = np.zeros((bsz, h // 2, wd // 2, cout), np.float32)
    pcover = np.zeros(pooled.shape, np.int32)
    index = {tuple(r): i for i, r in enumerate(rect)}
    for b_, xx, yy, n0 in blocks:
        t = tiles[index[(b_, xx, yy)]]
        hh, ww = min(th, h - yy), min(tw, wd - xx)
        nn = min(bn, cout - n0)
        y[b_, yy:yy + hh, xx:xx + ww, n0:n0 + nn] = t[:hh, :ww, n0:n0 + nn]
        cover[b_, yy:yy + hh, xx:xx + ww, n0:n0 + nn] += 1
        if pool:  # the epilogue's windows: pooled pixels inside the image
            assert th % 2 == 0 and tw % 2 == 0 and xx % 2 == 0 and yy % 2 == 0
            ph, pw = min(th // 2, h // 2 - yy // 2), min(tw // 2, wd // 2 - xx // 2)
            win = t[:2 * ph, :2 * pw, n0:n0 + nn].reshape(ph, 2, pw, 2, nn).max((1, 3))
            pooled[b_, yy // 2:yy // 2 + ph, xx // 2:xx // 2 + pw, n0:n0 + nn] = win
            pcover[b_, yy // 2:yy // 2 + ph, xx // 2:xx // 2 + pw, n0:n0 + nn] += 1
    if pool:
        return y, cover, pooled, pcover
    return y, cover


def _narrow(c: int) -> int:
    """A reduced width that keeps the route (a multiple of 8): 32-channel
    chunks up to Cin 256, one 64-channel chunk at 512, two at 1024."""
    return max(8, c // 8)


def _plain(x, w, bias):
    """conv3x3_plain in float32 (its float64 convs are slow on the CPU), the
    emulation held to it at float32's tolerance for sums in another order."""
    return ck.conv3x3_plain(*(torch.from_numpy(t).float() for t in (x, w, bias))).numpy()


def _conv_cases():
    seen = []
    for h, cin, cout in cs.CONVS:
        case = (h, cin, cout)
        if case not in seen:
            seen.append(case)
    return seen


@pytest.mark.parametrize("h,cin,cout", _conv_cases())
def test_conv_plan_covers_and_convolves(h, cin, cout):
    """Every conv shape of a fusion forward at batch 1-2 and reduced widths
    (Cin 3 takes the flat-K route and has no plan)."""
    if tp.conv_route(cin, cout) == "flat":
        assert cin == 3
        return
    cin_r, cout_r = _narrow(cin), _narrow(cout)
    bsz = 1 if h >= 256 else 2
    rng = np.random.default_rng(h + cin + cout)
    x = rng.normal(size=(bsz, h, h, cin_r))
    w = rng.normal(size=(3, 3, cin_r, cout_r)) / np.sqrt(9 * cin_r)
    bias = rng.normal(size=cout_r)
    y, cover = emulate_conv(x, w, bias, SMS)
    assert (cover == 1).all()
    np.testing.assert_allclose(y, _plain(x, w, bias), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bsz,h,wd,cin,cout,sms", [
    (1, 16, 16, 512, 1024, SMS), (1, 32, 32, 1024, 512, SMS), (2, 32, 32, 256, 512, 4),
    (3, 9, 11, 40, 72, SMS), (2, 5, 136, 8, 200, SMS), (1, 130, 260, 32, 24, SMS)])
def test_conv_plan_wide_and_ragged(bsz, h, wd, cin, cout, sms):
    """Full widths at the deep levels (several 64-channel chunks, 128- and
    256-channel tiles) and rectangles past the image (W 11: 11 x 11 pixels
    a block; W 136 and 260: a partial last rectangle; H 5 and 9 past TH)."""
    rng = np.random.default_rng(wd + cin)
    x = rng.normal(size=(bsz, h, wd, cin))
    w = rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
    bias = rng.normal(size=cout)
    plan = tp.conv_plan(bsz, h, wd, cin, cout, sms)
    assert plan["th"] * plan["tw"] <= tp.CONV_PIXELS
    y, cover = emulate_conv(x, w, bias, sms)
    assert (cover == 1).all()
    np.testing.assert_allclose(y, _plain(x, w, bias), rtol=1e-4, atol=1e-4)


def test_conv_plan_tiles():
    """The tile choices the C launcher makes: 128-pixel rectangles, 32- or
    64-channel chunks, 256 output channels only where that still gives a
    block an SM."""
    assert tp.conv_route(3, 32) == "flat" and tp.conv_route(32, 32) == "wgmma"
    assert tp.conv_route(64, 64, aligned=False) == "flat"
    p = tp.conv_plan(8, 512, 512, 32, 64, SMS)
    assert (p["tw"], p["th"], p["ck"], p["bn"], p["rects"]) == (128, 1, 32, 64, 8 * 512 * 4)
    p = tp.conv_plan(8, 16, 16, 512, 1024, SMS)
    assert (p["tw"], p["th"], p["ck"], p["bn"]) == (16, 8, 64, 128)
    p = tp.conv_plan(8, 64, 64, 128, 256, SMS)
    assert (p["tw"], p["th"], p["bn"], p["blocks"]) == (64, 2, 256, 256)
    assert tp.reduce_tile(32, 1024) == (64, 256) and tp.reduce_tile(1024, 32) == (128, 64)
    assert tp.reduce_splits(163840, 512, 1024, SMS) == 8


@pytest.mark.parametrize("bsz,h,wd,cin,cout", [
    (1, h, h, _narrow(c), _narrow(c)) for h, _, c, pool in cs.IMAGE_PAIRS if pool] + [
    (2, 10, 14, 8, 16), (1, 6, 200, 16, 72), (2, 12, 24, 8, 8)])
def test_pooled_conv_plan_covers_and_pools(bsz, h, wd, cin, cout):
    """K7's pooled second conv (Cin = Cout, the pair's C) at the five pooled
    pairs (2 x 64 rectangles wherever W >= 128, 8 x 16 at 16^2 and so on)
    and at ragged shapes (W 14: 14 x 8 rectangles past H 10; W 200: a
    partial last rectangle; W 24: 24 x 4): every output and pooled pixel
    covered once, the pool the plain version's."""
    rng = np.random.default_rng(h * wd + cin)
    x = rng.normal(size=(bsz, h, wd, cin))
    w = rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
    bias = rng.normal(size=cout)
    plan = tp.conv_plan(bsz, h, wd, cin, cout, SMS, pool=True)
    assert plan["th"] * plan["tw"] <= tp.CONV_PIXELS and plan["th"] % 2 == 0
    y, cover, pooled, pcover = emulate_conv(x, w, bias, SMS, pool=True)
    assert (cover == 1).all() and (pcover == 1).all()
    want_y = ck.conv3x3_plain(*(torch.from_numpy(t).float() for t in (x, w, bias)), True)
    want_p = torch.nn.functional.max_pool2d(want_y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y, want_y.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pooled, want_p.numpy(), rtol=1e-4, atol=1e-4)


def test_pooled_conv_plan_tiles():
    """The pooled rectangles the C launcher cuts: 2 x 64 at W >= 128, the
    unpooled plan's below (even heights there)."""
    for h, _, c, pool in cs.IMAGE_PAIRS:
        p = tp.conv_plan(8, h, h, c, c, SMS, pool=pool)
        if pool:
            assert (p["tw"], p["th"]) == ((64, 2) if h >= 128 else (h, 128 // h))
            assert p["tw"] % 2 == 0 and p["th"] % 2 == 0
        q = tp.conv_plan(8, h, h, c, c, SMS)
        if h < 128:
            assert (q["tw"], q["th"]) == (p["tw"], p["th"])


def emulate_level(s, c_last, weights, mask, f: int, fl: int):
    """c_out of K4 bf16's plan in float64 without its roundings, on one batch
    entry: s (N, F) the sample, c_last (N, Fl), weights as the wrapper
    passes them, mask (N,). Each block's two warpgroups walk the tiles of
    ``tile_plan.level_tiles`` in order: a chunk's hidden tile is written
    after its last W_in tile, and a W_out tile must find its chunk in the
    tile; o1 is parked at the first c_last tile. Returns c_out and the coverage
    counts of c_out, of the hidden columns (a row) and of the K indices of
    the three products (a row and output column's sum)."""
    p = tp.level_plan(f, fl)
    n = s.shape[0]
    fp, bm, hc, on, ki, ko = (p[k] for k in ("fp", "bm", "hc", "on", "ki", "ko"))
    f16 = -(-f // 16) * 16
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    nb = -(-n // bm)
    # zeros where the TMA zero-fills or the sample is zero
    sp = np.zeros((nb * bm, fp))
    sp[:n, :f] = s
    cp = np.zeros((nb * bm, p["n_c"] * ko))
    cp[:n, :fl] = c_last
    wi = np.zeros((p["n_in"] * ki, p["n_h"] * hc))
    wi[:f, :2 * f] = w_in
    wo = np.zeros((p["n_h"] * hc, fp))
    wo[:2 * f, :f] = w_out
    wc = np.zeros((p["n_c"] * ko, fp))
    wc[:fl, :f] = w_c
    bi = np.zeros(p["n_h"] * hc)
    bi[:2 * f] = b_in
    pad = lambda v: np.pad(v, (0, fp - f))  # noqa: E731
    bo, bc = pad(b_out), pad(b_c)
    out = np.zeros((n, f))
    cover = np.zeros((n, f), int)
    hcover = np.zeros((n, 2 * f), int)
    kcover = {"in": np.zeros(f, int), "out": np.zeros(2 * f, int), "c": np.zeros(fl, int)}
    tiles = tp.level_tiles(p)
    for blk in range(nb):
        i0 = blk * bm
        # per warpgroup: its rows, o columns and chunk columns
        wgs = [(slice(i0 + (0 if p["cols"] else 64 * w), i0 + (0 if p["cols"] else 64 * w) + 64),
                slice(on * w if p["cols"] else 0, (on * w if p["cols"] else 0) + on),
                64 * w if p["cols"] else 0) for w in (0, 1)]
        hacc = [np.zeros((64, p["hn"])) for _ in wgs]
        buf = [None for _ in wgs]  # (chunk, its part of the hidden tile)
        o = [np.zeros((64, on)) for _ in wgs]
        o1 = [None for _ in wgs]

        def tile_done(w, c):  # chunk c's part -> the hidden tile
            rows, _, hc0 = wgs[w]
            cols = slice(c * hc + hc0, c * hc + hc0 + p["hn"])
            h = np.maximum(hacc[w] + bi[cols], 0)
            h[:, np.arange(cols.start, cols.stop) >= 2 * f] = 0
            for r in range(rows.start, min(rows.stop, n)):
                hcover[r, cols.start:min(cols.stop, 2 * f)] += 1
            buf[w] = (c, h)
            hacc[w] = np.zeros((64, p["hn"]))

        for t, (kind, c, v) in enumerate(tiles):
            for w, (rows, oc, hc0) in enumerate(wgs):
                first = blk == 0 and w == 0
                if kind == "in":
                    cols = slice(c * hc + hc0, c * hc + hc0 + p["hn"])
                    for kk in range(min(ki, f16 - v * ki) // 16):
                        k = slice(v * ki + 16 * kk, v * ki + 16 * kk + 16)
                        hacc[w] += sp[rows, k] @ wi[k, cols]
                        if first and c == 0:
                            kcover["in"][k.start:min(k.stop, f)] += 1
                    if v == p["n_in"] - 1:
                        tile_done(w, c)
                elif kind == "out":
                    # the chunk's tile: both halves at F = 512, the own one below
                    parts = [buf[x] for x in ((0, 1) if p["cols"] else (w,))]
                    assert all(part is not None and part[0] == c for part in parts)
                    h = np.concatenate([part[1] for part in parts], 1)
                    kr = slice(v * ko, v * ko + ko)
                    o[w] += h[:, kr] @ wo[c * hc + kr.start:c * hc + kr.stop, oc]
                    if first:
                        lo = c * hc + kr.start
                        kcover["out"][lo:max(lo, min(lo + ko, 2 * f))] += 1
                else:
                    if v == 0:  # park o1, then o takes c_last W_c
                        o1[w], o[w] = o[w] + bo[oc], np.zeros((64, on))
                    k = slice(v * ko, v * ko + ko)
                    o[w] += cp[rows, k] @ wc[k, oc]
                    if first:
                        kcover["c"][k.start:min(k.stop, fl)] += 1
        for w, (rows, oc, _) in enumerate(wgs):
            res = o1[w] + o[w] + bc[oc]
            lo, hi = rows.start, min(rows.stop, n)
            ncol = max(0, min(oc.stop, f) - oc.start)
            if hi > lo and ncol:
                out[lo:hi, oc.start:oc.start + ncol] = res[:hi - lo, :ncol]
                cover[lo:hi, oc.start:oc.start + ncol] += 1
    out[~mask] = 0
    return out, cover, hcover, kcover


def _level_cases():
    seen = [(f, fl) for _, f, fl in cs.LEVEL_SHAPES]
    return list(dict.fromkeys(seen)) + [(512, 1024), (256, 1024), (8, 8), (24, 600),
                                        (200, 40), (64, 4 * 8)]


@pytest.mark.parametrize("f,fl", _level_cases())
def test_level_plan_covers_and_sums(f, fl):
    """K4 bf16's plan at every flagship level, at Fl = 1024 (the depth-6 up
    level) and at ragged widths (F 8 and 24: the last k16 step of the
    sample half past F; F 200: a cut W_in stage; Fl 600: a ragged c_last
    box), on 300
    rows (a ragged last block) with padding rows."""
    rng = np.random.default_rng(f + fl)
    n = 300
    s = rng.normal(size=(n, f))
    c_last = rng.normal(size=(n, fl))
    weights = (rng.normal(size=(f, 2 * f)) / np.sqrt(f), rng.normal(size=2 * f),
               rng.normal(size=(2 * f, f)) / np.sqrt(2 * f), rng.normal(size=f),
               rng.normal(size=(fl, f)) / np.sqrt(fl), rng.normal(size=f))
    mask = rng.random(n) > 0.2
    out, cover, hcover, kcover = emulate_level(s, c_last, weights, mask, f, fl)
    assert (cover == 1).all() and (hcover == 1).all()
    assert all((k == 1).all() for k in kcover.values())
    w_in, b_in, w_out, b_out, w_c, b_c = weights
    want = np.maximum(s @ w_in + b_in, 0) @ w_out + b_out + c_last @ w_c + b_c
    np.testing.assert_allclose(out, np.where(mask[:, None], want, 0), rtol=1e-12, atol=1e-10)


def test_level_plan_tiles():
    """The plan's classes: 128 rows a block up to F = 256, 64 at F = 512
    (o's columns split); the ring's stages fit the shared memory the C
    config asserts; the tile order takes every tile once, a chunk's W_in
    tiles before its W_out tiles."""
    assert [tp.level_plan(f, 64)["bm"] for f in (8, 32, 64, 128, 256, 512)] == [128] * 5 + [64]
    p = tp.level_plan(512, 256)
    assert p["cols"] and (p["on"], p["hc"], p["n_h"], p["n_in"], p["n_out"], p["n_c"]) == \
        (256, 128, 8, 4, 4, 8)
    for f in (64, 128, 256, 512):
        q = tp.level_plan(f, 64)
        stage = q["bm"] * q["ko"] * 2 + max(q["ki"] * q["hc"] * 2, q["ko"] * q["fp"] * 2)
        smem = 1024 + q["bm"] * q["fp"] * 2 + 16 * 1024 + q["stages"] * stage
        assert smem + 4096 <= 232448 // (2 if f == 64 else 1)
    tiles = tp.level_tiles(p)
    assert len(tiles) == len(set(tiles)) == p["n_h"] * (p["n_in"] + p["n_out"]) + p["n_c"]
    assert tiles[:12] == ([("in", 0, v) for v in range(4)] + [("out", 0, v) for v in range(4)]
                          + [("in", 1, v) for v in range(4)])
    with pytest.raises(ValueError):
        tp.level_plan(520, 8)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def emulate_head(x, x1, x2, w3, b3, w4, b4, plan):
    """K6's conv3 and head as the plan computes them: per block (one block
    column: n0 = 0) its rectangle of x3 = bf16(relu(conv3 + b3)) from
    ``emulate_conv``, then each pixel's two threads, thread hf on the
    16-byte chunks hf, hf + 2, ... of each part, their sums added, the parts
    added onto b4 in order; w4's columns ``oc`` a pass. Returns out and its
    coverage counts."""
    bsz, h, wd, c0 = x.shape
    c1, c2, c3, co = x1.shape[-1], x2.shape[-1], w3.shape[-1], w4.shape[-1]
    y3, cover3 = emulate_conv(x2, w3, b3, SMS)
    assert (cover3 == 1).all()
    x3 = _bf16(np.maximum(y3, 0))
    tw, th, oc = plan["tw"], plan["th"], plan["oc"]
    out = np.zeros((bsz, h, wd, co))
    cover = np.zeros((bsz, h, wd, co), np.int32)
    offs = np.cumsum([0, c0, c1, c2, c3])
    for blk in range(plan["blocks"]):
        b_, x0, y0, n0 = tp.conv_block(plan, c3, blk)
        assert n0 == 0  # one block column: all of x3's channels
        py, px = np.divmod(np.arange(tp.CONV_PIXELS), tw)
        keep = (py < th) & (y0 + py < h) & (x0 + px < wd)
        ys, xs = y0 + py[keep], x0 + px[keep]
        for o0 in range(0, co, oc):
            cols = slice(o0, min(o0 + oc, co))
            acc = np.broadcast_to(b4[cols], (len(ys), cols.stop - o0)).astype(np.float64)
            for i, part in enumerate((x, x1, x2, x3)):
                v = part[b_, ys, xs]  # (pixels, C)
                wk = w4[offs[i]:offs[i + 1], cols]
                chunk = np.arange(v.shape[-1]) // 8
                halves = [v[:, chunk % tp.HEAD_THREADS == hf] @ wk[chunk % tp.HEAD_THREADS == hf]
                          for hf in range(tp.HEAD_THREADS)]
                acc = acc + (halves[0] + halves[1])
            out[b_, ys, xs, cols] = acc
            cover[b_, ys, xs, cols] += 1
    return out, cover


@pytest.mark.parametrize("bsz,h,wd,c0,c1,c2,c3,co", [
    (1, 12, 136, 32, 64, 128, 64, 1), (2, 9, 11, 8, 16, 24, 16, 3),
    (1, 6, 20, 16, 8, 8, 64, 25), (1, 4, 130, 8, 8, 16, 40, 2)])
def test_decoder_plan_covers_and_decodes(bsz, h, wd, c0, c1, c2, c3, co):
    """The model's widths on a strip with a partial last rectangle (W 136),
    rectangles past the image (W 11: 11 x 11 pixels a block), two passes of
    w4's columns (CT 96, CO 25: 21 a pass), x3 narrower than its 64-channel
    block (C3 16, 40)."""
    rng = np.random.default_rng(h * wd + c3)
    x = _bf16(rng.normal(size=(bsz, h, wd, c0)))
    ws = [(_bf16(rng.normal(size=(3, 3, ci, c)) / np.sqrt(9 * ci)),
           _bf16(rng.normal(size=c) * 0.1)) for ci, c in ((c0, c1), (c1, c2), (c2, c3))]
    ct = c0 + c1 + c2 + c3
    w4 = _bf16(rng.normal(size=(ct, co)) / np.sqrt(ct))
    b4 = _bf16(rng.normal(size=co) * 0.1)
    plan = tp.decoder_plan(bsz, h, wd, c0, c1, c2, c3, co, SMS)
    assert plan["routes"] == ("wgmma",) * 3
    head = plan["head"]
    assert head["bn"] == 64 and head["blocks"] == head["rects"]
    assert head["oc"] == max(1, min(tp.HEAD_W4_BYTES // (4 * ct), co))
    assert -(-co // head["oc"]) == (2 if co == 25 else 1)
    x1 = ck.conv3x3_plain(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(ws[0][0]).to(torch.bfloat16),
                          torch.from_numpy(ws[0][1]), True)
    x2 = ck.conv3x3_plain(x1, torch.from_numpy(ws[1][0]).to(torch.bfloat16),
                          torch.from_numpy(ws[1][1]), True)
    out, cover = emulate_head(x, x1.float().numpy(), x2.float().numpy(), ws[2][0], ws[2][1],
                              w4, b4, head)
    assert (cover == 1).all()
    args = [torch.from_numpy(a) for a in (x, ws[0][0], ws[0][1], ws[1][0], ws[1][1],
                                          ws[2][0], ws[2][1], w4[None, None], b4)]
    want = dk.conv_decoder_plain(args[0].to(torch.bfloat16), *args[1:]).numpy()
    # x3's rounding may land one bf16 ulp apart where two f32 sums straddle
    # a rounding point: that moves out by at most ulp x |w4| summed over x3
    ulp = 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=ulp)


def test_decoder_plan_routes():
    """A width that is not a multiple of 8 (C0 = 3, C3 = 20), an unaligned
    tensor, or C3 past one 64-channel block column takes the conv core
    (or is refused); the model's decoder takes wgmma everywhere, with conv1
    on 32-channel chunks (CK 32) and 64 output channels, conv2 on 128, conv3
    on 64, and w4's one column in one pass."""
    h, c0, (c1, c2, c3), co = cs.DECODER
    p = tp.decoder_plan(8, h, h, c0, c1, c2, c3, co, SMS)
    assert p["routes"] == ("wgmma",) * 3
    assert (p["conv1"]["ck"], p["conv1"]["bn"], p["conv2"]["bn"]) == (32, 64, 128)
    assert (p["head"]["ck"], p["head"]["bn"], p["head"]["oc"]) == (64, 64, 1)
    assert (p["head"]["tw"], p["head"]["th"], p["head"]["blocks"]) == (128, 1, 8 * h * 4)
    assert tp.decoder_plan(2, 8, 8, 3, 64, 128, 64, 1, SMS)["routes"] == \
        ("flat", "wgmma", "flat")
    assert tp.decoder_plan(2, 8, 8, 32, 64, 128, 20, 1, SMS)["routes"] == \
        ("wgmma", "wgmma", "flat")
    assert tp.decoder_plan(2, 8, 8, 32, 64, 128, 64, 1, SMS, (True, False, False))["routes"] \
        == ("wgmma", "flat", "flat")
    assert tp.head_columns(288, 1) == 1 and tp.head_columns(288, 100) == 7
    assert tp.head_columns(4096, 5) == 1
    with pytest.raises(ValueError):
        tp.decoder_plan(2, 8, 8, 32, 64, 128, 72, 1, SMS)


# --- K5's bf16 row pass ----------------------------------------------------------------


def emulate_level_bwd(s, d_o, weights, f: int, fl: int):
    """K5 bf16's row pass as its plan computes it, in float64 without its
    roundings, on one batch entry: s (N, F) the sample, d_o (N, F), weights
    as the wrapper passes them. Each warpgroup takes its rings' tiles
    (``tile_plan.level_bwd_tiles``) in order. F <= 256: both warpgroups, for
    their own 64 rows, ring B's d_c_last stages, then per hidden chunk ring
    A's boxes for the pre-activation, ring B's W_out^T slices for d_h, and
    ring A's boxes again, K-major, for d_s. F = 512: warpgroup w, for all 64
    rows, phase A's pre-activations of its chunks, its half of d_c_last's
    columns, then per pair of chunks d_h of its chunk (its own gates) and
    its d_s columns from both chunks' d_h. Returns (d_c_last, h, d_h, d_s)
    and the coverage counts of each output element and of the K indices of
    the four products."""
    p = tp.level_bwd_plan(f, fl)
    n = s.shape[0]
    fp, bm, nc, kc, ns, sl = (p[k] for k in ("fp", "bm", "nc", "kc", "ns", "ki"))
    f16 = -(-f // 16) * 16
    w_in, b_in, w_out, _, w_c, _ = weights
    nb = -(-n // bm)
    # zeros where the TMA zero-fills or the tiles hold zeros
    sp = np.zeros((nb * bm, fp))
    sp[:n, :f] = s
    dp = np.zeros((nb * bm, fp))
    dp[:n, :f] = d_o
    wi = np.zeros((fp, p["n_h"] * sl))  # W_in (F, 2F)
    wi[:f, :2 * f] = w_in
    wot = np.zeros((fp, p["n_h"] * sl))  # W_out^T (F, 2F)
    wot[:f, :2 * f] = w_out.T
    wct = np.zeros((p["n_kc"] * kc, p["n_dc"] * nc))  # W_c^T (F, Fl)
    wct[:f, :fl] = w_c.T
    bi = np.zeros(p["n_h"] * sl)
    bi[:2 * f] = b_in
    outs = {"d_c_last": np.zeros((n, fl)), "h": np.zeros((n, 2 * f)),
            "d_h": np.zeros((n, 2 * f)), "d_s": np.zeros((n, f))}
    cover = {k: np.zeros(v.shape, int) for k, v in outs.items()}
    kcover = {k: np.zeros(w, int) for k, w in (("c", f), ("pre", f), ("dh", f), ("ds", 2 * f))}
    tiles = tp.level_bwd_tiles(p)

    def store(key, rows, cols, val):
        r_hi, c_hi = min(rows.stop, n), min(cols.stop, outs[key].shape[1])
        if r_hi > rows.start and c_hi > cols.start:
            outs[key][rows.start:r_hi, cols.start:c_hi] = val[:r_hi - rows.start,
                                                              :c_hi - cols.start]
            cover[key][rows.start:r_hi, cols.start:c_hi] += 1

    def k16(v, depth):  # the k16 steps of stage v of `depth` K rows, cut at F16
        return [slice(v * depth + 16 * kk, v * depth + 16 * kk + 16)
                for kk in range(max(0, min(depth, f16 - v * depth)) // 16)]

    def mark(key, ks, first, hi):
        if first:
            for k in ks:
                kcover[key][k.start:min(k.stop, hi)] += 1

    def pre_epilogue(acc, rows, c):
        cols = slice(c * sl, (c + 1) * sl)
        pre = acc + bi[cols]
        pre[:, np.arange(cols.start, cols.stop) >= 2 * f] = 0
        store("h", rows, cols, np.maximum(pre, 0))
        return pre > 0

    for blk in range(nb):
        i0, first = blk * bm, blk == 0
        if not p["split"]:
            for w in (0, 1):  # a warpgroup's own rows, every tile in order
                rows = slice(i0 + 64 * w, i0 + 64 * w + 64)
                ring_a, ring_b = iter(tiles["a"]), iter(tiles["b"])
                for j in range(p["n_dc"]):
                    acc = np.zeros((64, nc))
                    for v in range(p["n_kc"]):
                        assert next(ring_b) == ("c", j, v)
                        for k in k16(v, kc):
                            acc += dp[rows, k] @ wct[k, j * nc:(j + 1) * nc]
                        mark("c", k16(v, kc), first and w == 0 and j == 0, f)
                    store("d_c_last", rows, slice(j * nc, (j + 1) * nc), acc)
                ds = np.zeros((64, ns))
                for c in range(p["n_h"]):
                    cols = slice(c * sl, (c + 1) * sl)
                    acc = np.zeros((64, sl))
                    for v in range(p["n_in"]):
                        assert next(ring_a) == ("in", c, v)
                        for k in k16(v, sl):
                            acc += sp[rows, k] @ wi[k, cols]
                        mark("pre", k16(v, sl), first and w == 0 and c == 0, f)
                    gate = pre_epilogue(acc, rows, c)
                    acc = np.zeros((64, sl))
                    for v in range(p["n_in"]):
                        assert next(ring_b) == ("out", c, v)
                        for k in k16(v, sl):
                            acc += dp[rows, k] @ wot[k, cols]
                        mark("dh", k16(v, sl), first and w == 0 and c == 0, f)
                    dh = np.where(gate, acc, 0)
                    store("d_h", rows, cols, dh)
                    ds += dh @ wi[:ns, cols].T  # ring A's boxes again, K-major
                    if first and w == 0:
                        kcover["ds"][cols.start:min(cols.stop, 2 * f)] += 1
                store("d_s", rows, slice(0, ns), ds)
            continue
        rows = slice(i0, i0 + 64)
        seq = [list(tiles["wg0"]), list(tiles["wg1"])]

        def take(w, kind):
            t = seq[w].pop(0)
            assert t[0] == kind, (t, kind)
            return t

        gates = {}
        for w in (0, 1):  # phase A: the pre-activations of the warpgroup's chunks
            while seq[w] and seq[w][0][0] == "in":
                c = seq[w][0][1]
                assert c % 2 == w
                acc = np.zeros((64, sl))
                for v in range(p["n_in"]):
                    assert take(w, "in") == ("in", c, v)
                    for k in k16(v, sl):
                        acc += sp[rows, k] @ wi[k, c * sl:(c + 1) * sl]
                    mark("pre", k16(v, sl), first and c == 0, f)
                gates[c] = (w, pre_epilogue(acc, rows, c))
        half = nc // 2
        for w in (0, 1):  # d_c_last: half of each column chunk's columns
            for j in range(p["n_dc"]):
                cols = slice(j * nc + half * w, j * nc + half * w + half)
                acc = np.zeros((64, half))
                for v in range(p["n_kc"]):
                    assert take(w, "c") == ("c", j, v)
                    for k in k16(v, kc):
                        acc += dp[rows, k] @ wct[k, cols]
                    mark("c", k16(v, kc), first and w == 0 and j == 0, f)
                store("d_c_last", rows, cols, acc)
        ds = [np.zeros((64, ns)) for _ in (0, 1)]
        for pr in range(-(-p["n_h"] // 2)):
            dh = {}
            for w in (0, 1):  # d_h of the warpgroup's chunk of the pair
                c = 2 * pr + w
                if c >= p["n_h"]:
                    continue
                acc = np.zeros((64, sl))
                for v in range(p["n_in"]):
                    assert take(w, "out") == ("out", c, v)
                    for k in k16(v, sl):
                        acc += dp[rows, k] @ wot[k, c * sl:(c + 1) * sl]
                    mark("dh", k16(v, sl), first and c == 0, f)
                owner, gate = gates[c]
                assert owner == w  # its own gates
                dh[c] = np.where(gate, acc, 0)
                store("d_h", rows, slice(c * sl, (c + 1) * sl), dh[c])
            for w in (0, 1):  # its d_s columns from both chunks' d_h
                while seq[w] and seq[w][0][0] == "ds" and seq[w][0][1] // 2 == pr:
                    _, c, v = take(w, "ds")
                    assert 4 * w <= v < 4 * w + 4
                    nr = slice(v * sl, (v + 1) * sl)  # the box's rows: d_s columns
                    ds[w][:, nr.start - ns * w:nr.stop - ns * w] += \
                        dh[c] @ wi[nr, c * sl:(c + 1) * sl].T
                    if first and v == 0:
                        kcover["ds"][c * sl:min((c + 1) * sl, 2 * f)] += 1
        assert not seq[0] and not seq[1]
        for w in (0, 1):
            store("d_s", rows, slice(ns * w, ns * w + ns), ds[w])
    return outs, cover, kcover


def _level_bwd_cases():
    seen = [(_narrow_level(f), _narrow_level(fl)) for _, f, fl in cs.LEVEL_SHAPES]
    return list(dict.fromkeys(seen)) + [(512, 256), (512, 1024), (256, 128), (8, 8), (24, 600),
                                        (200, 40), (96, 8)]


def _narrow_level(w: int) -> int:
    """A level width cut for the CPU: each width class kept (32 and 64 in
    FP = 64, 128, 256), 512 cut to 264 (FP = 512: the split plan)."""
    return {512: 264}.get(w, w)


@pytest.mark.parametrize("f,fl", _level_bwd_cases())
def test_level_bwd_plan_covers_and_sums(f, fl):
    """K5 bf16's row-pass plan at the flagship's levels (F = 512 cut to 264,
    which keeps the split plan of FP = 512, and at full width), at Fl = 1024
    and at ragged widths (F 8, 24: k16 steps past F; 200: a cut box; Fl 600:
    a ragged column chunk), on 300 rows (a ragged last block): every row,
    hidden column and output column covered once, every K index once a
    product, and d_c_last, h, d_h and d_s equal to the plain row pass's."""
    rng = np.random.default_rng(f + 7 * fl)
    n = 300 if f < 256 else 130
    s = rng.normal(size=(n, f))
    d_o = rng.normal(size=(n, f))
    weights = (rng.normal(size=(f, 2 * f)) / np.sqrt(f), rng.normal(size=2 * f),
               rng.normal(size=(2 * f, f)) / np.sqrt(2 * f), rng.normal(size=f),
               rng.normal(size=(fl, f)) / np.sqrt(fl), rng.normal(size=f))
    outs, cover, kcover = emulate_level_bwd(s, d_o, weights, f, fl)
    assert all((c == 1).all() for c in cover.values())
    assert all((k == 1).all() for k in kcover.values())
    w_in, b_in, w_out, _, w_c, _ = weights
    pre = s @ w_in + b_in
    d_h = (d_o @ w_out.T) * (pre > 0)
    want = {"d_c_last": d_o @ w_c.T, "h": np.maximum(pre, 0), "d_h": d_h, "d_s": d_h @ w_in.T}
    for k, v in want.items():
        np.testing.assert_allclose(outs[k], v, rtol=1e-12, atol=1e-10, err_msg=k)


def test_level_bwd_plan_tiles():
    """The plan's classes: 128 rows a block up to F = 256, 64 and the split
    at F = 512; every class's shared memory fits (two blocks an SM at FP =
    64) with room for the static part; ring A holds one chunk of W_in; ring
    B takes d_c_last's stages first, then each chunk's W_out^T slices; at F
    = 512 each warpgroup's ring its phase-A boxes, its d_c_last stages, then
    per pair its d_h slices and its d_s boxes."""
    assert [tp.level_bwd_plan(f, 64)["bm"] for f in (8, 32, 64, 128, 256, 512)] == \
        [128] * 5 + [64]
    for f in (64, 128, 256, 512):
        q = tp.level_bwd_plan(f, 64)
        assert q["smem"] + 6144 <= 232448 // (2 if f == 64 else 1)
        assert q["ns"] * (2 if q["split"] else 1) == q["fp"]
        assert q["kc"] * q["nc"] * (1 if q["split"] else 2) == tp.LEVEL_BWD_STAGE
    q = tp.level_bwd_plan(256, 128)
    assert q["slots"] * q["ki"] == q["fp"] and (q["stages"], q["kc"]) == (5, 16)
    t = tp.level_bwd_tiles(q)
    assert t["b"][:16] == [("c", 0, v) for v in range(16)] and t["b"][16:20] == \
        [("out", 0, v) for v in range(4)] and len(t["a"]) == 8 * 4
    p = tp.level_bwd_plan(512, 256)
    assert p["split"] and (p["n_h"], p["n_in"], p["n_dc"], p["n_kc"], p["stages"], p["kc"]) == \
        (16, 8, 1, 16, 8, 32)
    t = tp.level_bwd_tiles(p)
    w0, w1 = t["wg0"], t["wg1"]
    assert w0[:8] == [("in", 0, v) for v in range(8)] and w1[:8] == [("in", 1, v) for v in range(8)]
    assert w0[64:80] == [("c", 0, v) for v in range(16)]
    assert w0[80:88] == [("out", 0, v) for v in range(8)]
    assert w0[88:96] == [("ds", 0, v) for v in range(4)] + [("ds", 1, v) for v in range(4)]
    assert w1[88:96] == [("ds", 0, v) for v in range(4, 8)] + [("ds", 1, v) for v in range(4, 8)]
    assert len(w0) == len(w1) == 64 + 16 + 8 * 16
    assert tuple(tp.LEVEL_BWD_PLAN_KEYS) == tuple(p)
    with pytest.raises(ValueError):
        tp.level_bwd_plan(520, 8)


# --- K5's d_plane pass ------------------------------------------------------------------


def _rowmajor(code, reso):
    return cs.morton_rowmajor(np.asarray(code, np.int64), reso)


def _corner(u, v, r):
    """csrc/bilinear.cuh bilinear_corner in float32: x0, y0, x1, y1, wx, wy."""
    rmax = np.float32(r - 1)
    x = np.minimum(np.maximum(u * rmax, np.float32(0)), rmax)
    y = np.minimum(np.maximum(v * rmax, np.float32(0)), rmax)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, r - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, r - 1)
    wx = (x - x0.astype(np.float32)).astype(np.float32)
    wy = (y - y0.astype(np.float32)).astype(np.float32)
    return x0, y0, np.minimum(x0 + 1, r - 1), np.minimum(y0 + 1, r - 1), wx, wy


def _corner_weight(corner, px, py):
    """csrc/level_bwd.cu corner_weight at (px, py), uncut (float32)."""
    x0, y0, x1, y1, wx, wy = corner
    one = np.float32(1)
    w = np.zeros(np.shape(x0), np.float32)
    for yy, xx, wt in ((y0, x0, (one - wx) * (one - wy)), (y0, x1, wx * (one - wy)),
                       (y1, x0, (one - wx) * wy), (y1, x1, wx * wy)):
        w = np.where((yy == py) & (xx == px), w + wt, w).astype(np.float32)
    return w


def d_plane_layout(seed: int, fr: int, n: int, b: int = 2):
    """b patches of n points on the aligned layout at finest resolution fr
    (pads past the points, cells PAD_CELL_SENTINEL), entry 0 with a crowded
    corner and some valid cells' rows masked, the last entry empty. Returns
    xy (b, Npad, 2), cells (b, Npad), mask (b, Npad) and each finest cell's
    row range (start, end) at its row-major index, as the mark pass writes
    it."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import host_morton_bucket_aligned

    rng = np.random.default_rng(seed)
    tile = min(1024, fr * fr)
    out = []
    for i in range(b):
        p = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        p[:3, :2] = [[0, 0], [1, 1], [0.5, 0.5]]
        if i == 0:
            p[3:n // 4, :2] = rng.uniform(0.0, 0.08, (n // 4 - 3, 2))
        m = np.full(n, i < b - 1)
        a = host_morton_bucket_aligned(p, m, fr, tile_cells=tile)
        out.append(a)
    npad = max(len(a["mask"]) for a in out)
    xy = np.full((b, npad, 2), 0.5, np.float32)
    cells = np.full((b, npad), np.iinfo(np.int32).max, np.int64)
    mask = np.zeros((b, npad), bool)
    for i, a in enumerate(out):
        k = len(a["mask"])
        xy[i, :k], cells[i, :k], mask[i, :k] = a["points"][:, :2], a["cells"], a["mask"]
    mask[0, ::7] = False  # masked rows inside valid cells
    start = np.zeros((b, fr * fr), np.int64)
    end = np.zeros((b, fr * fr), np.int64)
    for i in range(b):
        ok = cells[i] < fr * fr
        rm = _rowmajor(cells[i][ok], fr)
        rows = np.flatnonzero(ok)
        for c in np.unique(rm):
            sel = rows[rm == c]
            assert (np.diff(sel) == 1).all()  # one run a cell
            start[i, c], end[i, c] = sel[0], sel[-1] + 1
    return xy, cells.astype(np.int32), mask, start, end


def emulate_d_plane_tiles(d_s, xy, mask, start, end, r: int, fr: int, elem: int, picks=()):
    """``d_plane_tiles`` as its plan walks: per tile, the cells under its
    rectangle in row-major order, ``cells`` a step, their rows in order,
    ``cap`` a batch; each pixel adds, in that order, the rows of its own
    rectangle whose corner weight there is not 0. Returns d_plane (B, R, R,
    F; float32 folds), the row sequences of the pixels ``picks`` ({(b, py,
    px): [rows]}), and the stores' counts (B, R, R, F)."""
    b, _, f = d_s.shape
    p = tp.d_plane_plan(r, f, fr, elem)
    out = np.zeros((b, r, r, f), np.float32)
    seqs = {}
    picks = set(picks)
    lo, hi = np.array([tp.cell_span(v, r, fr) for v in range(r)]).T
    for bi in range(b):
        corner = _corner(xy[bi, :, 0], xy[bi, :, 1], r)
        for ty in range(p["tiles_y"]):
            for tx in range(p["tiles_x"]):
                (x0, x1, y0, y1), (cx0, cx1, cy0, cy1) = tp.d_plane_tile_rect(p, r, fr, tx, ty)
                cy, cx = np.divmod(np.arange((cy1 - cy0 + 1) * (cx1 - cx0 + 1)), cx1 - cx0 + 1)
                cy, cx = cy + cy0, cx + cx0
                at = cy * fr + cx
                # the list: the steps of `cells` cells in order, each cell's
                # rows in order (the batches of `cap` rows keep that order)
                n = end[bi, at] - start[bi, at]
                if n.sum() == 0:
                    continue
                first = np.repeat(start[bi, at] - np.cumsum(n) + n, n)
                lst = first + np.arange(n.sum())
                lcy, lcx = np.repeat(cy, n), np.repeat(cx, n)
                pys, pxs = np.meshgrid(np.arange(y0, y1 + 1), np.arange(x0, x1 + 1), indexing="ij")
                pys, pxs = pys.ravel()[:, None], pxs.ravel()[:, None]
                inr = ((lcy >= lo[pys]) & (lcy <= hi[pys]) & (lcx >= lo[pxs])
                       & (lcx <= hi[pxs]) & mask[bi, lst])
                w = _corner_weight(tuple(c[lst] for c in corner), pxs, pys)
                w = np.where(inr, w, np.float32(0))
                pys, pxs = pys[:, 0], pxs[:, 0]
                acc = np.zeros((len(pys), f), np.float32)
                for e, row in enumerate(lst):  # the fold, in list order
                    hit = w[:, e] != 0
                    if hit.any():
                        acc[hit] = (acc[hit] + w[hit, e, None] * d_s[bi, row]).astype(np.float32)
                out[bi, pys, pxs] = acc
                for k, (y, x) in enumerate(zip(pys, pxs)):
                    if (bi, y, x) in picks:
                        seqs[(bi, y, x)] = list(lst[w[k] != 0])
    # the stores: block (tile, chunk), thread -> (pixel, vec features)
    writes = np.zeros((b, r, r, f), int)
    tid = np.arange(p["threads"])
    pid, g = np.divmod(tid, p["tpp"])
    for ty in range(p["tiles_y"]):
        for tx in range(p["tiles_x"]):
            px, py = tx * p["tx"] + pid % p["tx"], ty * p["ty"] + pid // p["tx"]
            ok = (pid < p["tx"] * p["ty"]) & (px < r) & (py < r)
            for ch in range(p["chunks"]):
                for lane in range(p["groups"]):  # thread g's lanes lane * tpp + g
                    for v in range(p["vec"]):
                        ff = ch * p["fc"] + (lane * p["tpp"] + g) * p["vec"] + v
                        k = ok & (ff < f)
                        np.add.at(writes, (slice(None), py[k], px[k], ff[k]), 1)
    return out, seqs, writes


def own_walk(xy, mask, start, end, r: int, fr: int, bi: int, px: int, py: int):
    """The rows a walk of pixel (px, py)'s own rectangle adds, in its order
    (the cells row-major, each cell's rows in order, nonzero weights)."""
    lox, hix = tp.cell_span(px, r, fr)
    loy, hiy = tp.cell_span(py, r, fr)
    rows = [np.arange(start[bi, cy * fr + cx], end[bi, cy * fr + cx])
            for cy in range(loy, hiy + 1) for cx in range(lox, hix + 1)]
    rows = np.concatenate(rows) if rows else np.zeros(0, int)
    rows = rows[mask[bi, rows]]
    w = _corner_weight(_corner(xy[bi, rows, 0], xy[bi, rows, 1], r), px, py)
    return list(rows[w != 0])


def _d_plane_cases():
    seen = [(r, _narrow_dplane(f), 256) for r, f, _ in cs.LEVEL_SHAPES]
    return list(dict.fromkeys(seen)) + [(1, 8, 8), (2, 24, 8), (3, 8, 16), (32, 8, 32),
                                        (16, 40, 16)]


def _narrow_dplane(f: int) -> int:
    """A level width cut for the CPU: 512 to 264 (at R = 32 still 16 threads
    a pixel, a ragged last lane group)."""
    return {512: 264}.get(f, f)


@pytest.mark.parametrize("r,f,fr", _d_plane_cases())
@pytest.mark.parametrize("elem", [2, 4])
def test_d_plane_plan_walks_each_pixel_in_its_order(r, f, fr, elem):
    """The d_plane pass's tiles at every level R of the flagship (fr = 256,
    widths cut) and at R = 1, 2, 3, fr = R and a ragged F, on the aligned
    layout with a crowded corner, masked rows in valid cells and an empty
    entry: each pixel's rows are those of a walk of its own rectangle, in
    the same order (the parent kernel's sum, term by term); every pixel and
    feature stored once; the sums equal the plain transpose."""
    n = (1000 if r == 256 else 1200) if fr == 256 else 60 * fr // 8 + 40
    xy, cells, mask, start, end = d_plane_layout(r * 31 + f + fr, fr, n)
    rng = np.random.default_rng(r + f)
    d_s = rng.normal(size=mask.shape + (f,)).astype(np.float32)
    b = mask.shape[0]
    picks = [(bi, py, px) for bi in range(b) for py in range(r) for px in range(r)]
    step = max(1, len(picks) // 300)  # a sample of the pixels, corners included
    picks = picks[::step] + [(0, 0, 0), (0, r - 1, r - 1), (0, 0, r - 1)]
    out, seqs, writes = emulate_d_plane_tiles(d_s, xy, mask, start, end, r, fr, elem, picks)
    assert (writes == 1).all()
    for bi, py, px in picks:
        assert seqs.get((bi, py, px), []) == own_walk(xy, mask, start, end, r, fr, bi, px, py)
    want = lk.level_d_plane_plain(torch.from_numpy(d_s), torch.from_numpy(xy),
                                  torch.from_numpy(cells), torch.from_numpy(mask), r, fr)
    np.testing.assert_allclose(out, want.numpy(), rtol=2e-4, atol=2e-5)
    assert (out[-1] == 0).all()


def test_d_plane_plan_tiles():
    """The plan's shapes: 16-byte lanes; more pixels at fine levels (R = fr:
    a thread takes up to 32 sums, 256 pixels a block at F = 32 in bf16),
    fewer at coarse ones (R = fr / 8: 16 threads a pixel, 16 pixels, a 4 x 4
    tile, F = 512 in one chunk); a ragged F in f32 at R = fr; the line
    buffers hold 24 KB; the tiles cover R; the C side's key order."""
    p = tp.d_plane_plan(256, 32, 256, 2)
    assert (p["vec"], p["fc"], p["tpp"], p["groups"], p["tx"], p["ty"], p["chunks"]) == \
        (8, 32, 1, 4, 16, 16, 1)
    p = tp.d_plane_plan(128, 128, 256, 2)
    assert (p["tpp"], p["groups"], p["tx"], p["ty"], p["chunks"]) == (4, 4, 8, 8, 1)
    p = tp.d_plane_plan(32, 512, 256, 2)
    assert (p["fc"], p["tpp"], p["groups"], p["tx"], p["ty"], p["chunks"], p["lines"]) == \
        (512, 16, 4, 4, 4, 1, 24)
    p = tp.d_plane_plan(32, 512, 256, 4)
    assert (p["vec"], p["fc"], p["groups"], p["chunks"], p["tiles_x"], p["tiles_y"]) == \
        (4, 512, 8, 1, 8, 8)
    p = tp.d_plane_plan(64, 100, 64, 4)
    assert (p["tpp"], p["groups"], p["fc"], p["chunks"]) == (4, 7, 112, 1)
    p = tp.d_plane_plan(3, 4, 3, 4)
    assert (p["tpp"], p["tx"], p["ty"], p["tiles_x"], p["tiles_y"]) == (1, 16, 16, 1, 1)
    assert p["lines"] == p["cap"] == p["cells"] == 512
    assert tuple(tp.D_PLANE_PLAN_KEYS) == tuple(p)
    with pytest.raises(ValueError):
        tp.d_plane_plan(64, 8, 32, 4)


# --- K9: the tile gather on 16-byte lanes ----------------------------------------------


def _bf16_round(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def emulate_tile_gather(plane, xy, toff, elem: int, aligned: bool = True):
    """K9 (``csrc/tile_gather.cu`` ``tile_gather_lanes``) in numpy on
    ``tile_plan.tile_gather_plan``, every warp's lanes at once: lane r
    computes the corner of the warp's row r; in each step a lane's items e
    (row (e // lpr) % 32, chunk (e // (32 lpr)) lpr + e % lpr) take the
    corner from the row's lane, load vec features of the four corners and
    write them once (0 past the entry's last tile offset). ``elem`` 2: the plane's values are
    bf16 (the weights cut, the exact products summed in float32 in corner
    order, one rounding); 4: float32 (bilinear_mix without contraction).
    Returns (out (B, N, F) float32, writes (B, N, F))."""
    b, r, _, f = plane.shape
    n = xy.shape[1]
    p = tp.tile_gather_plan(f, elem, aligned)
    vec, cpr, lpr, rows = p["vec"], p["cpr"], p["lpr"], p["rows"]
    out = np.full((b, n, f), np.nan, np.float32)
    writes = np.zeros((b, n, f), np.int64)
    one = np.float32(1)
    warps = tp.cdiv(n, p["block_rows"]) * tp.GATHER_WARPS
    i0 = np.arange(warps)[:, None] * rows  # (W, 1): each warp's first row
    lanes = np.arange(32)[None, :]
    feats = np.arange(vec)
    here = np.clip(n - i0, 0, rows)  # (W, 1): the warp's rows in the entry
    for bi in range(b):
        last = int(toff[bi, -1])
        flat = plane[bi].reshape(r * r, f)
        own = i0 + lanes < n  # lane r: the corner of the warp's row r (W, 32)
        src = np.minimum(i0 + lanes, n - 1)
        x0, y0, x1, y1, wx, wy = _corner(np.where(own, xy[bi, src, 0], 0).astype(np.float32),
                                         np.where(own, xy[bi, src, 1], 0).astype(np.float32), r)
        step = 32 * p["items"]
        for e0 in range(0, rows * cpr, step):  # steps of ``items`` items a lane
            assert e0 // step < p["steps"]
            for half in range(0, step, 32):
                e = e0 + half + lanes
                h = e // lpr
                row = h % rows
                k = ((h // rows) * lpr + e % lpr) * vec
                live = (e < rows * cpr) & (row < here)  # (W, 32)
                wi, li = np.nonzero(live)
                rr, kk = row[0, li], k[0, li]
                assert (rr < 32).all() and (kk + vec <= f).all()  # a chunk inside its row
                i = i0[wi, 0] + rr
                fs = kk[:, None] + feats[None, :]
                np.add.at(writes[bi], (i[:, None], fs), 1)
                past = i >= last
                out[bi, i[past, None], fs[past]] = 0
                s_w, s_r, s_f = wi[~past], rr[~past], fs[~past]
                assert own[s_w, s_r].all()  # the item's corner: its row's own lane
                c = [flat[yy[s_w, s_r, None] * r + xx[s_w, s_r, None], s_f]
                     for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
                bx, by = wx[s_w, s_r, None], wy[s_w, s_r, None]
                ax, ay = one - bx, one - by
                if elem == 2:
                    wts = [_bf16_round(w) for w in (ax * ay, bx * ay, ax * by, bx * by)]
                    acc = wts[0] * c[0]
                    for t in (1, 2, 3):
                        acc = (acc + wts[t] * c[t]).astype(np.float32)
                    val = _bf16_round(acc)
                else:
                    val = (c[0] * ax + c[1] * bx) * ay + (c[2] * ax + c[3] * bx) * by
                out[bi, i[~past, None], s_f] = val
    return out, writes


def _gather_case(seed: int, r: int, f: int, elem: int, edge: str = "border"):
    """A 2-entry fused layout at finest 64^2 (the last entry empty with
    ``edge`` 'empty'), the plane at R in the element type, the tile offsets
    at R and the points' mask, as tests/test_torch_bf16_tiles.py builds
    them."""
    from test_torch_cuda import tile_batch

    pts, mask, _, toff, _ = tile_batch(seed, n=300, reso=64, edge=edge)
    plane = np.random.default_rng(seed + 1).normal(size=(2, r, r, f)).astype(np.float32)
    if elem == 2:
        plane = _bf16_round(plane)
    lvl = np.ascontiguousarray(toff[:, :: 4 ** ((64).bit_length() - r.bit_length())])
    return plane, np.ascontiguousarray(pts[..., :2]), lvl, mask


@pytest.mark.parametrize("f,elem,aligned", [
    (32, 2, True), (64, 2, True), (128, 2, True), (256, 2, True), (512, 2, True),
    (24, 2, True), (40, 2, True), (12, 2, True), (32, 2, False), (264, 2, True),
    (32, 4, True), (64, 4, True), (512, 4, True), (6, 4, True), (64, 4, False)])
def test_tile_gather_plan_covers_and_samples(f, elem, aligned):
    """Every (row, feature) of the output written once by one lane's chunk,
    no chunk past its row, each item's corner from its row's own lane, rows
    past the last tile 0, the samples equal to the plain version's (bf16:
    the same bits; f32: 1e-6, the kernel contracts into FMAs)."""
    plane, xy, lvl, _ = _gather_case(3, 32, f, elem)
    out, writes = emulate_tile_gather(plane, xy, lvl, elem, aligned)
    assert (writes == 1).all()
    dt = torch.bfloat16 if elem == 2 else torch.float32
    want = gk.tile_gather_plain(torch.from_numpy(plane).to(dt), torch.from_numpy(xy),
                                torch.from_numpy(lvl)).float().numpy()
    past = np.arange(xy.shape[1])[None, :] >= lvl[:, -1:]
    assert past.any() and (out[past] == 0).all()
    if elem == 2:
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r,finest_edge", [(32, "empty")])
def test_tile_gather_emulation_matches_jax(r, finest_edge):
    """The bf16 emulation at F = 64 against the JAX kernel in interpret mode
    (its bf16 rule, gather_kernel.py:174-186) on the points' rows: within one
    bf16 ulp, as tests/test_torch_bf16_tiles.py holds the plain version."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from tomosar2height_tpu.ops.pallas import fused as jfused
    from tomosar2height_tpu.ops.pallas.gather_kernel import pallas_tile_gather

    plane, xy, lvl, mask = _gather_case(5, r, 64, 2, finest_edge)
    out, _ = emulate_tile_gather(plane, xy, lvl, 2)
    ax, ay = jfused.make_aux(jnp.asarray(xy))
    want = np.asarray(pallas_tile_gather(jnp.asarray(plane, jnp.bfloat16), ax, ay,
                                         jnp.asarray(lvl), r, interpret=True)).astype(np.float32)
    got, ref = out[mask], want[mask]
    ulp = np.maximum(np.abs(ref), 2.0 ** -126) * 2.0 ** -7
    assert (np.abs(got - ref) <= ulp).all()


def test_tile_gather_plan_shapes():
    """The maps: 32 rows a warp; in bf16 one item a lane at once, a row of F
    = 32 on 4 lanes (8 rows a step), F = 256 on 32; past 32 chunks a row (F
    = 512 in bf16, 256 and 512 in f32) 32 lanes a row, the warp's rows
    walked once a group of 32 chunks; f32 two items a lane; an unaligned
    plane or a ragged F on one feature a lane; one lane a row at F = 132 in
    f32 (the largest power of two dividing 33 chunks); the C side's key
    order."""
    shapes = {f: tp.tile_gather_plan(f, 2) for f in (32, 64, 128, 256, 512)}
    assert [(p["vec"], p["cpr"], p["lpr"], p["items"], p["steps"])
            for p in shapes.values()] == [
        (8, 4, 4, 1, 4), (8, 8, 8, 1, 8), (8, 16, 16, 1, 16), (8, 32, 32, 1, 32),
        (8, 64, 32, 1, 64)]
    p = tp.tile_gather_plan(512, 4)
    assert (p["vec"], p["cpr"], p["lpr"], p["items"], p["rows"], p["steps"],
            p["block_rows"]) == (4, 128, 32, 2, 32, 64, 256)
    assert tp.tile_gather_plan(32, 2, aligned=False)["vec"] == 1
    assert tp.tile_gather_plan(20, 2)["vec"] == 1 and tp.tile_gather_plan(20, 4)["vec"] == 4
    assert tp.tile_gather_plan(132, 4)["lpr"] == 1
    assert tuple(tp.TILE_GATHER_PLAN_KEYS) == tuple(p)
    with pytest.raises(ValueError):
        tp.tile_gather_plan(0, 2)
