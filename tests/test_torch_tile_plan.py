"""The host plans of the two bf16 kernels on the TMA and wgmma
(``ops/cuda/tile_plan.py``, mirrored by ``csrc/reduce_bf16.cu`` and
``csrc/conv_bf16.cu``), emulated in numpy on the CPU (the sums in float64,
the convs in float32):

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
  the result equals ``conv3x3_plain``'s.

The card's tests check that the C side takes the same tiles
(``tests/test_torch_cuda.py::TestWgmmaBf16Kernels``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
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


def emulate_conv(x, w, bias, sms: int):
    """y = conv3x3(x, w) + bias as the plan computes it: per block its
    rectangle and channel tile, each tap's box at ``tap_origin``, zeros past
    the image and past Cin, summed over the taps and the ck-channel chunks.
    Returns y and the coverage count of each output element."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    plan = tp.conv_plan(bsz, h, wd, cin, cout, sms)
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
    y = np.zeros((bsz, h, wd, cout), np.float32)
    cover = np.zeros((bsz, h, wd, cout), np.int32)
    index = {tuple(r): i for i, r in enumerate(rect)}
    for b_, xx, yy, n0 in blocks:
        t = tiles[index[(b_, xx, yy)]]
        hh, ww = min(th, h - yy), min(tw, wd - xx)
        nn = min(bn, cout - n0)
        y[b_, yy:yy + hh, xx:xx + ww, n0:n0 + nn] = t[:hh, :ww, n0:n0 + nn]
        cover[b_, yy:yy + hh, xx:xx + ww, n0:n0 + nn] += 1
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
