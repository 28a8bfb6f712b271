"""The host plans of the bf16 kernels on the TMA and wgmma
(``ops/cuda/tile_plan.py``, mirrored by ``csrc/reduce_bf16.cu``,
``csrc/conv_bf16.cu`` and ``csrc/level_bf16.cu``), emulated in numpy on the
CPU (the sums in float64, the convs in float32):

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
