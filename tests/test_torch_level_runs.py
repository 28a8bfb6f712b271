"""K4's plane and K5's d_plane as the card computes them, emulated in numpy
step by step on fused2's aligned layout (finest 256^2, 1024-cell tiles).

- K4 (``ops/cuda/level_kernel._fused_level``): ``csrc/level.cu`` writes c_out,
  then the run scatter (``csrc/pool2.cu`` ``t2h_scatter_runs``, emulated by
  ``test_torch_scatter_runs.emulate_scatter``) writes the plane and counts
  from c_out at the level's shift. Its contract, each coarse cell's valid rows
  one run, is held at every resolution K4 runs (256, 128, 64 and 32 from 256^2,
  ``chip_smoke.LEVEL_SHAPES``); the emulation is held to
  ``fused_level_plain`` and to the JAX ``fused_level`` (Pallas in interpret
  mode) at 1e-5, every plane cell written once.
- K5's d_plane (``level_d_plane``, ``csrc/level_bwd.cu``
  ``t2h_level_d_plane``): the mark pass writes each finest cell's row range;
  each pixel adds the rows of its rectangle of finest cells (``cell_span``:
  the cells of the rows whose corner can touch the pixel, widened by
  ``MARGIN`` cells each side) in row-major order and each cell's rows in row
  order, weight x d_s where the row's corner touches the pixel (a block a
  tile of pixels walks the union of their rectangles in that order:
  ``tests/test_torch_tile_plan.py`` holds each pixel's terms to this
  walk's). The emulation sums in that order and is held to
  ``grid_sample_2d_adjoint`` (``level_d_plane_plain``) and to the d_plane of
  the JAX ``fused_level_bwd_call`` (``jax.grad`` of ``fused_level``,
  interpret mode) at K5's tolerance (2e-5 abs + 2e-4 rel), on layouts with
  points at u = 0, u = 1 and on exact pixel boundaries of every level, an
  empty batch entry, and at every level; every pixel is stored once. A
  layout whose host cells lie one finest cell off trunc(xy * 256) (cells
  made from moved points) needs the margin: the mutant without it drops
  rows.

Also: no float atomic is left in ``csrc/`` (no atomic at all), and
``tile_scatter.cu`` is gone."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_cuda import t  # noqa: E402
from test_torch_level import run_jax  # noqa: E402
from test_torch_level_bwd import jax_grads  # noqa: E402
from test_torch_scatter_runs import emulate_scatter, rowmajor  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import tile_plan  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import (  # noqa: E402
    PAD_CELL_SENTINEL,
    host_morton_bucket_aligned,
)

FINEST = 256
LEVELS = (256, 128, 64, 32)  # K4's resolutions (chip_smoke.LEVEL_SHAPES)
MARGIN = 1  # kMargin in csrc/level_bwd.cu
TOL = dict(rtol=1e-5, atol=1e-5)
PLANE_TOL = dict(atol=2e-5, rtol=2e-4)
CSRC = os.path.join(os.path.dirname(lk.__file__), "..", "..", "csrc")


def level_run_batch(seed: int, moved: bool = False):
    """Four patches of 1200 points on fused2's aligned layout: entry 0 has
    uniform points plus points at u = 0, u = 1 and on exact pixel boundaries
    k / (R - 1) of every level R (in x, in y and in both); entry 1 crowds 300
    points into one finest cell and 300 into one 8 x 8 block (runs of one
    coarse cell longer than a 32-row span); entry 2 has no valid row; entry 3
    is uniform with a tenth masked. ``moved``: the cells (and so the row
    order) come from the points moved by up to 0.99 of a finest cell on each
    axis, the coordinates stay: a host cell one off trunc(xy * 256).
    Returns points, mask, cells, tile offsets."""
    rng = np.random.default_rng(seed)
    n = 1200
    out = {k: [] for k in ("points", "mask", "cells", "tile_offsets")}
    for i in range(4):
        p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        m = np.ones(n, bool)
        if i == 0:
            p[:4, :2] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]]
            j = 4
            for r in LEVELS:
                k = rng.integers(0, r, (3, 12))
                edge = (k.astype(np.float32) / np.float32(r - 1)).astype(np.float32)
                p[j:j + 12, 0] = edge[0]
                p[j + 12:j + 24, 1] = edge[1]
                p[j + 24:j + 36, :2] = np.stack([edge[2], edge[0]], -1)
                j += 36
        if i == 1:
            p[:300, :2] = (np.array([100, 37]) + rng.uniform(0.1, 0.9, (300, 2))) / FINEST
            p[300:600, :2] = (np.array([64, 192]) + rng.uniform(0, 8, (300, 2))) / FINEST
        if i == 2:
            m[:] = False
        if i == 3:
            m = rng.random(n) > 0.1
        src = p.copy()
        if moved:
            src[:, :2] = np.clip(p[:, :2] + rng.uniform(-0.99, 0.99, (n, 2)) / FINEST,
                                 0.0, np.nextafter(np.float32(1), np.float32(0)))
        src[:, 2] = np.arange(n)  # to find each row's point again
        a = host_morton_bucket_aligned(src, m, FINEST)
        rows = a["mask"]
        a["points"][rows] = p[a["points"][rows, 2].astype(np.int64)]
        for k in out:
            out[k].append(a[k])
    return tuple(np.stack(out[k]) for k in out)


def level_args(layout, level_reso, f, fl, seed):
    """``level_inputs``' tuple (points, mask, cells, toff, plane, c_last,
    weights) on ``layout`` at ``level_reso``."""
    pts, mask, cells, toff = layout
    rng = np.random.default_rng(seed)
    b, npad = mask.shape
    plane = rng.normal(0, 1, (b, level_reso, level_reso, f)).astype(np.float32)
    c_last = np.where(mask[..., None], rng.normal(0, 1, (b, npad, fl)), 0).astype(np.float32)
    s = lambda fan, *sh: rng.normal(0, min(0.2, fan ** -0.5), sh).astype(np.float32)  # noqa: E731
    weights = (s(f, f, 2 * f), s(1, 2 * f), s(2 * f, 2 * f, f), s(1, f), s(fl, fl, f), s(1, f))
    return pts, mask, cells, toff, plane, c_last, weights


def shift_of(reso):
    return lk.level_shift(reso, FINEST)


def _runs_per_cell(key):
    heads = np.flatnonzero((key >= 0) & np.r_[True, key[1:] != key[:-1]])
    return np.bincount(key[heads])


@pytest.fixture(scope="module")
def layout():
    return level_run_batch(5)


@pytest.fixture(scope="module")
def moved_layout():
    return level_run_batch(5, moved=True)


# --- K4: c_out, then the run scatter at the level's shift --------------------------


@pytest.mark.parametrize("reso", LEVELS + (FINEST,))
def test_fused2_layout_holds_one_run_per_cell(layout, reso):
    """K4's contract at every level (and the finest cells', which K5's mark
    pass reads): each occupied cell's valid rows are one run, even the
    crowded cells of entry 1."""
    _, mask, cells, _ = layout
    for i in range(mask.shape[0]):
        key = np.where(mask[i] & (cells[i] < PAD_CELL_SENTINEL),
                       cells[i].astype(np.int64) >> shift_of(reso), -1)
        assert (_runs_per_cell(key) <= 1).all(), reso
    key = np.where(mask[1], cells[1] >> shift_of(32), -1)
    assert _runs_per_cell(key).size and np.bincount(key[key >= 0]).max() >= 300


@pytest.mark.parametrize("reso", LEVELS)
def test_k4_plane_emulation_matches_plain_and_jax(layout, reso):
    """c_out of the plain version through the emulated run scatter: the
    plane within 1e-5 of ``fused_level_plain``'s and of the JAX kernel's,
    the counts equal, every plane cell written once, the empty entry 0."""
    inp = level_args(layout, reso, 4, 4, seed=reso)
    pts, mask, cells, _, plane, c_last, weights = inp
    want = lk.fused_level_plain(t(plane), t(c_last), tuple(t(w) for w in weights),
                                t(pts[..., :2]), t(cells), t(mask), reso, FINEST)
    got, counts, writes = emulate_scatter(want[1].numpy(), cells, reso, mask=mask,
                                          shift=shift_of(reso))
    assert (writes == 1).all()
    np.testing.assert_allclose(got, want[0].numpy(), **TOL)
    np.testing.assert_array_equal(counts, want[2].numpy())
    assert (got[2] == 0).all() and (counts[2] == 0).all()
    jax_plane, _ = run_jax(inp, FINEST, reso)
    np.testing.assert_allclose(got, jax_plane, **TOL)


def test_k4_launches_the_run_scatter():
    """K4's kernel writes c_out only; the wrapper scatters it with the run
    kernel at the level's shift and counts that launch apart."""
    import inspect

    src = inspect.getsource(lk._fused_level)
    assert "scatter_runs_masked(" in src and "level_shift(reso, finest)" in src
    assert 'launched("fused_level_scatter"' in src and 'launched("fused_level"' in src
    body = open(os.path.join(CSRC, "level.cu")).read()
    assert "plane_out" not in body and "atomicAdd(" not in body


# --- K5: the d_plane pass ------------------------------------------------------------


def corner_np(u, v, r):
    """csrc/bilinear.cuh bilinear_corner in float32: x0, y0, x1, y1, wx, wy."""
    rmax = np.float32(r - 1)
    x = np.minimum(np.maximum(u * rmax, np.float32(0)), rmax)
    y = np.minimum(np.maximum(v * rmax, np.float32(0)), rmax)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, r - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, r - 1)
    wx = (x - x0.astype(np.float32)).astype(np.float32)
    wy = (y - y0.astype(np.float32)).astype(np.float32)
    return x0, y0, np.minimum(x0 + 1, r - 1), np.minimum(y0 + 1, r - 1), wx, wy


def corner_weight_np(corner, px, py):
    """csrc/level_bwd.cu corner_weight: the sum of the corners' weights at
    (px, py), in the adjoint's corner order."""
    x0, y0, x1, y1, wx, wy = corner
    one = np.float32(1)
    ax, ay = one - wx, one - wy
    w = np.zeros(np.shape(px), np.float32)
    for yy, xx, wt in ((y0, x0, ax * ay), (y0, x1, wx * ay), (y1, x0, ax * wy),
                       (y1, x1, wx * wy)):
        w = np.where((yy == py) & (xx == px), w + wt, w).astype(np.float32)
    return w


def cell_span_np(p, r, fr, margin=MARGIN):
    """csrc/level_bwd.cu cell_span for pixels ``p`` (array): [lo, hi]."""
    p = np.asarray(p, np.int64)
    if r < 2:
        return np.zeros_like(p), np.full_like(p, fr - 1)
    lo = np.where(p >= 1, (p - 1) * fr // (r - 1) - margin, 0)
    hi = (p + 1) * fr // (r - 1) + margin
    return np.maximum(lo, 0), np.minimum(hi, fr - 1)


def emulate_d_plane(d_s, xy, cells, mask, reso, fr=FINEST, margin=MARGIN):
    """The steps of ``t2h_level_d_plane`` in numpy. d_s (B, N, F). Returns
    (d_plane (B, R, R, F), writes (B, R, R, F): how often each element was
    stored, rows_used (B, N): how many pixels each row was added to)."""
    b, n, f = d_s.shape
    ncell = fr * fr
    # the mark pass: each finest cell's row range, at its row-major index
    start = np.zeros((b, ncell), np.int64)
    end = np.zeros((b, ncell), np.int64)
    c = cells.astype(np.int64)
    ok = (c >= 0) & (c < ncell)
    prev = np.concatenate([np.full((b, 1), -1), c[:, :-1]], 1)
    nxt = np.concatenate([c[:, 1:], np.full((b, 1), -1)], 1)
    for i in range(b):
        rows = np.arange(n)
        head, tail = ok[i] & (prev[i] != c[i]), ok[i] & (nxt[i] != c[i])
        start[i, rowmajor(c[i, head], fr)] = rows[head]
        end[i, rowmajor(c[i, tail], fr)] = rows[tail] + 1
    # per axis: the pixels whose rectangle holds cell k, and its place there
    lo, hi = cell_span_np(np.arange(reso), reso, fr, margin)
    pix_of = [np.flatnonzero((lo <= k) & (k <= hi)) for k in range(fr)]
    out = np.zeros((b * reso * reso, f), np.float32)
    used = np.zeros((b, n), np.int64)
    keys, vals = [], []
    for i in range(b):
        for cell in np.flatnonzero(end[i] > start[i]):
            cy, cx = divmod(int(cell), fr)
            rows = np.arange(start[i, cell], end[i, cell])
            rows = rows[mask[i, rows]]
            if rows.size == 0:
                continue
            corner = corner_np(xy[i, rows, 0], xy[i, rows, 1], reso)
            for py in pix_of[cy]:
                for px in pix_of[cx]:
                    w = corner_weight_np(corner, px, py)
                    hit = w != 0
                    if not hit.any():
                        continue
                    span_x = hi[px] - lo[px] + 1
                    rank = (cy - lo[py]) * span_x + (cx - lo[px])
                    pix = (i * reso + py) * reso + px
                    for r, wr in zip(rows[hit], w[hit]):
                        keys.append((pix, rank, r))
                        vals.append(wr * d_s[i, r])
                        used[i, r] += 1
    if keys:
        keys = np.array(keys)
        order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))  # the warps' sum order
        np.add.at(out, keys[order, 0], np.array(vals, np.float32)[order])
    # the stores: block = (tile of pixels, chunk of fc features), a thread
    # (pixel, vec features) (tile_plan.d_plane_plan)
    p = tile_plan.d_plane_plan(reso, f, fr, d_s.itemsize)
    writes = np.zeros((b, reso, reso, f), np.int64)
    pid, g = np.divmod(np.arange(p["threads"]), p["tpp"])
    for ty in range(p["tiles_y"]):
        for tx in range(p["tiles_x"]):
            px, py = tx * p["tx"] + pid % p["tx"], ty * p["ty"] + pid // p["tx"]
            ok = (pid < p["tx"] * p["ty"]) & (px < reso) & (py < reso)
            for ch in range(p["chunks"]):
                for lane in range(p["groups"]):  # thread g's lanes lane * tpp + g
                    for v in range(p["vec"]):
                        ff = ch * p["fc"] + (lane * p["tpp"] + g) * p["vec"] + v
                        k = ok & (ff < f)
                        np.add.at(writes, (slice(None), py[k], px[k], ff[k]), 1)
    return out.reshape(b, reso, reso, f), writes, used


def pixels_touched(xy, mask, reso):
    """(B, N): the distinct pixels at which each valid row's sample weighs
    more than 0 (0 on rows that are not valid): how many pixels must add it."""
    corner = corner_np(xy[..., 0], xy[..., 1], reso)
    x0, y0, x1, y1 = corner[:4]
    count = np.zeros(mask.shape, np.int64)
    for px, py, dup in ((x0, y0, False), (x1, y0, x1 == x0), (x0, y1, y1 == y0),
                        (x1, y1, (x1 == x0) | (y1 == y0))):
        count += (corner_weight_np(corner, px, py) != 0) & ~np.asarray(dup)
    return np.where(mask, count, 0)


def _d_s(inp, reso, seed):
    """The rows' d_s of K5's plain row pass for ``inp`` at ``reso``, with the
    forward's counts and random output cotangents; and those cotangents."""
    pts, mask, cells, _, plane, c_last, weights = inp
    args = (t(plane), t(c_last), tuple(t(w) for w in weights), t(pts[..., :2]), t(cells),
            t(mask))
    counts = lk.fused_level_plain(*args, reso, FINEST)[2]
    rng = np.random.default_rng(seed)
    g_p = rng.normal(0, 1, plane.shape).astype(np.float32)
    g_c = rng.normal(0, 1, mask.shape + (plane.shape[-1],)).astype(np.float32)
    rows = lk.fused_level_bwd_rows_plain(*args, counts, t(g_p), t(g_c), reso, FINEST)
    return rows[-1].reshape(g_c.shape).numpy(), g_p, g_c


def test_layout_reaches_the_edges(layout, moved_layout):
    """Points at u = 0 and u = 1 and on exact pixel boundaries of every
    level; the empty entry; the moved layout's cells one off their points."""
    pts, mask, cells, _ = layout
    xy = pts[0][mask[0], :2]
    assert ((xy == 0).all(-1)).any() and ((xy == 1).all(-1)).any()
    for r in LEVELS:
        on_edge = np.isclose(xy * (r - 1), np.round(xy * (r - 1)), rtol=0, atol=1e-4)
        assert on_edge.all(-1).sum() >= 10, r
    assert not mask[2].any()
    mpts, mmask, mcells, _ = moved_layout
    ok = mmask & (mcells < PAD_CELL_SENTINEL)
    cx = np.clip((mpts[..., 0] * FINEST).astype(np.int64), 0, FINEST - 1)
    hx = rowmajor(mcells.astype(np.int64), FINEST) % FINEST
    off = np.abs(cx - hx)[ok]
    assert off.max() == 1 and (off == 1).sum() >= 100


@pytest.mark.parametrize("reso", LEVELS)
def test_d_plane_emulation_matches_plain_and_jax(layout, reso):
    """The emulated pass on the plain row pass's d_s: within K5's tolerance
    of ``grid_sample_2d_adjoint`` and of the JAX K5's d_plane (whose
    unvisited windows are NaN: the empty entry is compared to 0 instead);
    every pixel stored once; every valid row added to as many pixels as its
    nonzero corner weights."""
    inp = level_args(layout, reso, 4, 4, seed=40 + reso)
    pts, mask, cells = inp[:3]
    d_s, g_p, g_c = _d_s(inp, reso, seed=reso)
    got, writes, used = emulate_d_plane(d_s, pts[..., :2], cells, mask, reso)
    assert (writes == 1).all()
    want = lk.level_d_plane_plain(t(d_s), t(pts[..., :2]), t(cells), t(mask), reso, FINEST)
    np.testing.assert_allclose(got, want.numpy(), **PLANE_TOL)
    assert (got[2] == 0).all()
    np.testing.assert_array_equal(used, pixels_touched(pts[..., :2], mask, reso))
    jax_d_plane = jax_grads(inp, g_p, g_c, FINEST, reso)[0]
    np.testing.assert_allclose(got[:2], jax_d_plane[:2], **PLANE_TOL)
    np.testing.assert_allclose(got[3], jax_d_plane[3], **PLANE_TOL)


@pytest.mark.parametrize("reso", [256, 32])
def test_d_plane_margin_takes_cells_one_off(moved_layout, reso):
    """Host cells one finest cell off trunc(xy * 256): the pass with its
    one-cell margin matches the plain adjoint (which reads no cell); the
    mutant without the margin drops rows and leaves it."""
    inp = level_args(moved_layout, reso, 4, 4, seed=50 + reso)
    pts, mask, cells = inp[:3]
    d_s, _, _ = _d_s(inp, reso, seed=reso + 1)
    want = lk.level_d_plane_plain(t(d_s), t(pts[..., :2]), t(cells), t(mask), reso,
                                  FINEST).numpy()
    got, writes, used = emulate_d_plane(d_s, pts[..., :2], cells, mask, reso)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, want, **PLANE_TOL)
    need = pixels_touched(pts[..., :2], mask, reso)
    np.testing.assert_array_equal(used, need)
    bad, _, used = emulate_d_plane(d_s, pts[..., :2], cells, mask, reso, margin=0)
    assert (used < need).sum() >= 10
    assert not np.allclose(bad, want, **PLANE_TOL)


def test_d_plane_sums_in_a_fixed_order(layout):
    """A pixel's value is the float32 left fold of its rows' weight x d_s in
    rectangle-cell order, then row order: entry 1's crowded cell at 256^2
    shows it (300 rows into four pixels)."""
    inp = level_args(layout, 256, 4, 4, seed=7)
    pts, mask, cells = inp[:3]
    d_s, _, _ = _d_s(inp, 256, seed=8)
    got, _, _ = emulate_d_plane(d_s, pts[..., :2], cells, mask, 256)
    corner = corner_np(pts[1, :, 0], pts[1, :, 1], 256)
    px, py = 100, 37
    w = corner_weight_np(corner, px, py)
    lo, hi = cell_span_np(np.arange(256), 256, FINEST)
    cxy = rowmajor(cells[1].astype(np.int64), FINEST)
    cy, cx = cxy // FINEST, cxy % FINEST
    rank = (cy - lo[py]) * (hi[px] - lo[px] + 1) + (cx - lo[px])
    rows = np.flatnonzero(mask[1] & (w != 0))
    fold = np.zeros(4, np.float32)
    for r in rows[np.lexsort((rows, rank[rows]))]:
        fold = fold + w[r] * d_s[1, r]
    assert rows.size >= 300
    np.testing.assert_array_equal(got[1, py, px], fold)


def test_d_plane_wrapper_and_source():
    """The wrapper launches ``t2h_level_d_plane`` and counts it; K5 runs the
    row pass, then the d_plane pass, then the three reductions; the source
    keeps the emulated margin, walks a tile's rectangle of cells in
    row-major order and adds to each pixel only the rows of its own
    rectangle, as emulated."""
    import inspect

    src = inspect.getsource(lk.level_d_plane)
    assert 'entry("level_d_plane"' in src and 'launched("level_d_plane"' in src
    bwd = inspect.getsource(lk.fused_level_bwd)
    assert bwd.index("fused_level_bwd_rows(") < bwd.index("level_d_plane(") < bwd.index(
        "level_bwd_reduce(")
    body = open(os.path.join(CSRC, "level_bwd.cu")).read()
    assert f"constexpr int kMargin = {MARGIN};" in body
    assert "(long long)(p - 1) * fr / (R - 1)) - kMargin" in body
    assert "(long long)(p + 1) * fr / (R - 1)) + kMargin" in body
    assert "(long long)(cly + ky) * fr + clx + (k - ky * span_x)" in body
    assert "if (cy <= hiy && cx >= lox && cx <= hix) {" in body  # the pixel's own cells
    assert "if ((s_ent[l0 + mid].x >> 16) < loy) e0w = mid + 1;" in body


def test_csrc_has_no_atomics():
    """Every kernel writes each output element once, in a fixed order: no
    atomic of any kind is left in the sources (the integer atomics that
    remain would be named here), and the last file with shared float
    atomics is gone."""
    allowed: list = []  # (file, call) pairs of integer atomics, none today
    found = []
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu*")))
    assert len(sources) >= 10
    for path in sources:
        for line in open(path):
            code = line.split("//")[0]
            if "atomic" in code:
                found.append((os.path.basename(path), code.strip()))
    assert found == allowed
    assert not os.path.exists(os.path.join(CSRC, "tile_scatter.cu"))
    for path in sources:
        src = open(path).read()
        assert "atomic_max_f32" not in src and "fill_f32" not in src
        assert "divide_by_counts" not in src
