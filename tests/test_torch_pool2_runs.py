"""The partition of ``pool2``'s run kernel (``csrc/pool2.cu`` ``pool_runs``,
which also serves K10 ``tile_pool`` under the tile rule), emulated in numpy
step by step as the kernel takes it: warps own 32-row spans
(``SPAN``, the kernel's ``kSpan``), a run belongs to the warp whose span holds its
head, a segmented scan in row order reduces each run, the last run reads on
past the span to its end, and a backward fill hands each row its run's result.
The emulation is held to the plain versions (``pool2_plain``,
``pool2_bwd_plain``) and through them to the JAX ``pool2`` and its vjp (Pallas
in interpret mode), on layouts from ``host_morton_bucket_aligned`` made to hit
the partition's edges (``test_torch_cuda.run_batch``): a cell of 300 rows,
runs straddling every span edge, a batch entry with no valid row, ties in max,
every tile padded, and rows cleared from the mask inside a run. Each row must
be written exactly once. K10's cases replace the mask by the tile rule (a
row is valid when its cell's 256-cell tile's row range holds it) on the
fused layout (``test_torch_cuda.tile_run_batch``: pads at tile ends,
runs across span edges, a 300-row cell, an empty entry, rows of another tile
in pad rows, rows past the last tile with in-range ids), held to
``tile_pool_plain`` and to the JAX ``pallas_tile_pool`` (interpret mode, on
the rows inside the tiles: it leaves the rest undefined); a mutant without
the read-on or without the tile check must fail. K2 alone (``pool_gather``,
``scatter_plane2``'s backward) on the same partition: a warp's lanes take
its span's rows, a valid row loads its cell's plane row (divided by the
count) only where the previous valid row of the span holds another cell, and
every row takes the latest load; held to ``scatter_plane2_bwd_plain`` and to
the vjp of the JAX ``scatter_plane2`` (its gather kernel in interpret mode)
on the same layouts and on unsorted rows; mutants that reuse a value across
a cell change must fail. Tolerance 1e-5 abs + rel (the kernel sums in row
order, the plain version in scatter order); max exact."""

from __future__ import annotations

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.ops.pallas.level_kernel import (  # noqa: E402
    chunk_metadata,
    make_cells_row,
)
from tomosar2height_tpu.ops.pallas.level_kernel import empty_tile_mask  # noqa: E402
from tomosar2height_tpu.ops.pallas.pool2_kernel import pool2 as jax_pool2  # noqa: E402
from tomosar2height_tpu.ops.pallas.pool2_kernel import (  # noqa: E402
    scatter_plane2 as jax_scatter_plane2,
)
from tomosar2height_tpu.ops.pallas.pool_kernel import pallas_tile_pool  # noqa: E402
from test_torch_cuda import RESO, run_batch, t, tile_run_batch  # noqa: E402
from test_torch_scatter_runs import rowmajor  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import PAD_CELL_SENTINEL  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NCELL = RESO * RESO
SPAN = 32  # rows a warp owns: kSpan in csrc/pool2.cu
SOURCE = os.path.join(os.path.dirname(pk.__file__), "..", "..", "csrc", "pool2.cu")


def emulate_runs(x, cells, mask, ncell, kind, tie=None, span=SPAN, toff=None, mutant=None):
    """The run kernel in numpy, warp by warp: returns (out, writes), writes
    counting how often each row was stored. x (B, N, F) f32; kind 'max' |
    'mean' | 'sum' | 'split'; tie (values, out) gates a sum as max pooling's
    backward: 'sum' gives each tied row the run's sum (pool2's), 'split'
    divides it by the run's tied valid rows, feature by feature (K10's);
    toff (B, T + 1) tile offsets: K10's tile rule in place of ``mask``.
    ``mutant``: 'no_read_on' drops the walk past the span, 'no_tile_check'
    takes every row with an in-range id as valid."""
    b, n, _ = x.shape
    out = np.full_like(x, np.nan)
    writes = np.zeros((b, n), np.int64)
    ident = np.float32(-np.inf if kind == "max" else 0.0)
    comb = np.maximum if kind == "max" else np.add

    def finalize(a, count, tied):  # a run with no valid row gives no row its value
        if kind == "split":
            return np.where(tied > 0, a / np.maximum(tied, 1).astype(np.float32),
                            np.float32(0))
        return a / np.float32(max(count, 1)) if kind == "mean" else a

    def ties(i, rows):
        """Per feature, how many of ``rows`` of entry i tie (split only)."""
        if kind != "split" or not rows:
            return np.zeros(x.shape[-1], np.int64)
        return sum((tie[0][i, r] == tie[1][i, r]).astype(np.int64) for r in rows)

    def gated(r, row, i):
        return r if tie is None else np.where(tie[0][i, row] == tie[1][i, row], r, 0)

    for i in range(b):
        def cell(r):
            return int(cells[i, r]) if 0 <= r < n else -1

        def is_valid(r):
            c = cell(r)
            if not 0 <= c < ncell:
                return False
            if toff is None:
                return bool(mask[i, r])
            return mutant == "no_tile_check" or toff[i, c >> 8] <= r < toff[i, (c >> 8) + 1]

        for s0 in range(0, n, span):
            rows = range(s0, s0 + span)
            ok = [0 <= cell(r) < ncell for r in rows]
            heads = [ok[k] and cell(r - 1) != cell(r) for k, r in enumerate(rows)]
            valid = [is_valid(r) for r in rows]
            first = heads.index(True) if any(heads) else span
            own = [valid[k] and k >= first for k in range(span)]
            cont = ok[-1] and first < span and cell(s0 + span) == cell(s0 + span - 1)
            # segmented scan in row order
            v, acc = [], np.full(x.shape[-1], ident, np.float32)
            for k, r in enumerate(rows):
                if heads[k]:
                    acc = np.full(x.shape[-1], ident, np.float32)
                if own[k]:
                    acc = comb(acc, x[i, r])
                v.append(acc)
            # the last run past the span
            tail = []
            if cont and mutant != "no_read_on":
                j = s0 + span
                while cell(j) == cell(s0 + span - 1):
                    if is_valid(j):
                        tail.append(j)
                    j += 1
                for j in tail:
                    acc = comb(acc, x[i, j])
            # backward fill
            cur = np.zeros(x.shape[-1], np.float32)
            for k in reversed(range(span)):
                r = s0 + k
                if ok[k] and (cell(r + 1) != cell(r) or k == span - 1):
                    hs = [h for h in range(k + 1) if heads[h]]
                    count = sum(own[hs[-1]:k + 1]) if hs else 0
                    tied = ties(i, [s0 + h for h in range(hs[-1], k + 1) if own[h]]
                                if hs else [])
                    a = v[k]
                    if k == span - 1 and cont:
                        a = acc
                        count += len(tail)
                        tied = tied + ties(i, tail)
                    cur = finalize(a, count, tied)
                v[k] = cur
            # store: own rows and rows that are not valid; then the tail
            for k, r in enumerate(rows):
                if r >= n or (valid[k] and not own[k]):
                    continue
                out[i, r] = gated(v[k], r, i) if own[k] else 0
                writes[i, r] += 1
            for j in tail:
                out[i, j] = gated(v[-1], j, i)
                writes[i, j] += 1
    return out, writes


@pytest.fixture(scope="module", params=["aligned", "holes"])
def layout(request):
    return run_batch(3, holes=request.param == "holes")


def _assert_close(got, want, kind):
    if kind == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_layouts_reach_the_partition_edges():
    _, mask, cells, toff, vals = run_batch(3)
    span = SPAN
    ok = cells < NCELL
    for i, c in enumerate(cells):
        edges = [s for s in range(span, c.size, span) if ok[i, s] and c[s] == c[s - 1]]
        starts = np.flatnonzero(ok[i] & np.r_[True, c[1:] != c[:-1]])
        longest = max((np.flatnonzero(c[h:] != c[h])[:1].tolist() or [c.size - h])[0]
                      for h in starts) if starts.size else 0
        if i == 0:  # runs of 37-38 rows straddle every span edge of their rows
            assert longest > span and len(edges) >= 26
            used = np.diff(toff[i])
            assert (used > 0).all() and (used % 128 == 0).all()
            tile_rows = [np.count_nonzero(mask[i, a:e]) for a, e in zip(toff[i], toff[i, 1:])]
            assert all(r < u for r, u in zip(tile_rows, used))  # every tile ends in pads
        if i == 1:
            assert longest == 300  # one cell of 300 rows crosses ten spans
        if i == 2:
            assert (vals[2][mask[2]] % 1 == 0).all()  # values in {0, 1, 2}: ties
    assert not mask[3].any()


@pytest.mark.parametrize("kind", ["max", "mean", "sum"])
def test_emulation_matches_plain_forward(layout, kind):
    _, mask, cells, _, vals = layout
    got, writes = emulate_runs(vals, cells, mask, NCELL, kind)
    assert (writes == 1).all()  # every row stored once, by one warp
    want = pk.pool2_plain(t(vals), t(cells), t(mask), RESO, kind).numpy()
    _assert_close(got, want, kind)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("kind", ["max", "mean"])
def test_emulation_matches_plain_backward(layout, kind):
    _, mask, cells, _, vals = layout
    g = np.random.default_rng(5).normal(size=vals.shape).astype(np.float32)
    out = pk.pool2_plain(t(vals), t(cells), t(mask), RESO, kind).numpy()
    tie = None if kind == "mean" else (vals, out)
    got, writes = emulate_runs(g, cells, mask, NCELL, "mean" if kind == "mean" else "sum", tie)
    assert (writes == 1).all()
    want = pk.pool2_bwd_plain(t(g), t(vals), t(out), t(cells), t(mask), RESO, kind).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["max", "mean"])
def test_emulation_matches_jax_forward_and_vjp(kind):
    """On the aligned layout proper (no holes: the Pallas kernel pools by
    cell id alone and masks only its output)."""
    _, mask, cells, toff, vals = run_batch(3)
    ct, _ = chunk_metadata(jnp.asarray(toff), mask.shape[1], RESO, RESO)
    cells_row = make_cells_row(jnp.asarray(cells))
    g = np.random.default_rng(6).normal(size=vals.shape).astype(np.float32)

    def f(v):
        return jax_pool2(v, cells_row, ct, jnp.asarray(mask), NCELL // 1024, kind)

    want, vjp = jax.vjp(f, jnp.asarray(vals))
    (want_dv,) = vjp(jnp.asarray(g))
    got, _ = emulate_runs(vals, cells, mask, NCELL, kind)
    _assert_close(got, np.asarray(want), kind)
    tie = None if kind == "mean" else (vals, got)
    dv, _ = emulate_runs(g, cells, mask, NCELL, "mean" if kind == "mean" else "sum", tie)
    np.testing.assert_allclose(dv, np.asarray(want_dv), **TOL)


def test_emulation_sums_in_row_order():
    """A run's sum is taken in row order, so the kernel's result is the
    float32 left fold over the run; a 300-row run shows it."""
    _, mask, cells, _, vals = run_batch(3)
    got, _ = emulate_runs(vals, cells, mask, NCELL, "sum")
    rows = np.flatnonzero(mask[1] & (cells[1] == np.bincount(cells[1][mask[1]]).argmax()))
    assert rows.size == 300
    fold = np.zeros(vals.shape[-1], np.float32)
    for r in rows:
        fold = fold + vals[1, r]
    np.testing.assert_array_equal(got[1, rows], np.broadcast_to(fold, (300, vals.shape[-1])))


def test_kernel_source_matches_the_emulation():
    """The emulated span is the kernel's, and the run kernel adds with no
    atomic (K3's scatter in the same file keeps its atomics)."""
    src = open(SOURCE).read()
    assert f"constexpr int kSpan = {SPAN};" in src
    body = src[src.index("pool_runs(const float*"):src.index("// K2 alone")]
    assert "atomic" not in body
    assert "t2h_pool_reduce" not in src  # the cell-buffer reduce is retired


# --- K10: the tile rule ---------------------------------------------------------


@pytest.fixture(scope="module", params=["fused", "foreign"])
def k10_layout(request):
    """The fused layout; 'foreign' adds rows of another tile in pad rows and
    rows past the last tile with in-range ids."""
    edges = request.param == "foreign"
    return tile_run_batch(11, foreign=edges, past=edges)


def _tile_pool_emulated(layout, kind, mutant=None):
    _, mask, cells, toff, vals = layout
    return emulate_runs(vals, cells, mask, (toff.shape[1] - 1) * 256, kind, toff=toff,
                        mutant=mutant)


def test_k10_layouts_reach_the_edges():
    _, mask, cells, toff, vals = tile_run_batch(11, foreign=True, past=True)
    n = cells.shape[1]
    ok = cells < PAD_CELL_SENTINEL
    assert sum(1 for s in range(SPAN, n, SPAN) if ok[0, s] and cells[0, s] == cells[0, s - 1]) >= 26
    assert (toff % 128 == 0).all() and (toff[:, -1] < n).sum() == 3 and toff[3, -1] == 0
    past = [i for i in range(4) if toff[i, -1] < n]
    assert all(cells[i, -1] < 256 for i in past)  # in range, past the last tile
    rows = np.arange(n)[None, :]
    tile_of_row = np.searchsorted(toff[0], np.arange(n), side="right") - 1
    foreign = ok[0] & (rows[0] < toff[0, -1]) & ((cells[0] >> 8) != tile_of_row)
    assert foreign.sum() >= 3 and not mask[0, foreign].any()
    assert (vals[~mask] == 1e9).all() and not mask[3].any()


@pytest.mark.parametrize("kind", ["max", "mean"])
def test_k10_emulation_matches_plain(k10_layout, kind):
    """Every row written once; every row that is not valid (pads, rows of
    another tile, rows past the last tile) 0."""
    _, mask, cells, toff, vals = k10_layout
    got, writes = _tile_pool_emulated(k10_layout, kind)
    assert (writes == 1).all()
    want = tpk.tile_pool_plain(t(vals), t(cells), t(toff), kind).numpy()
    _assert_close(got, want, kind)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("kind", ["max", "mean"])
def test_k10_emulation_matches_jax(kind):
    """The Pallas kernel in interpret mode, on the rows inside the tiles."""
    layout = tile_run_batch(11, foreign=True, past=True)
    _, _, cells, toff, vals = layout
    want = np.asarray(pallas_tile_pool(jnp.asarray(vals), jnp.asarray(cells.reshape(4, -1, 128)),
                                       jnp.asarray(toff), kind, interpret=True))
    got, _ = _tile_pool_emulated(layout, kind)
    inside = np.arange(cells.shape[1])[None, :] < toff[:, -1:]
    _assert_close(got[inside], want[inside], kind)


@pytest.mark.parametrize("mutant", ["no_read_on", "no_tile_check"])
def test_k10_mutants_fail(mutant):
    """Without the walk past the span, runs longer than a span lose rows;
    without the tile check, the junk on rows of another tile leaks."""
    layout = tile_run_batch(11, foreign=True, past=True)
    _, _, cells, toff, vals = layout
    got, _ = _tile_pool_emulated(layout, "mean", mutant)
    want = tpk.tile_pool_plain(t(vals), t(cells), t(toff), "mean").numpy()
    assert not np.allclose(got, want, **TOL)


def _k10_bwd_case(layout, ties: bool):
    """K10's max-pool backward inputs: the cotangent on the valid rows, the
    values (integral, so that cells tie in their max, with ``ties``) and
    K10's forward output."""
    _, mask, cells, toff, vals = layout
    rng = np.random.default_rng(12)
    if ties:
        vals = np.where(mask[..., None], rng.integers(0, 3, vals.shape), vals).astype(np.float32)
    g = (rng.normal(size=vals.shape) * mask[..., None]).astype(np.float32)
    out = tpk.tile_pool_plain(t(vals), t(cells), t(toff), "max").numpy()
    return g, vals, out, cells, toff, mask


@pytest.mark.parametrize("ties", [False, True])
def test_k10_backward_emulation_matches_plain(k10_layout, ties):
    """K10's max backward on the run kernel (kind 3): each run's cotangent
    sum split among its tied rows, feature by feature, as the vjp of the
    plain version and JAX's segment_max split it (held to JAX in
    tests/test_torch_sorted_train.py)."""
    g, vals, out, cells, toff, mask = _k10_bwd_case(k10_layout, ties)
    ncell = (toff.shape[1] - 1) * 256
    got, writes = emulate_runs(g, cells, mask, ncell, "split", (vals, out), toff=toff)
    assert (writes == 1).all()
    want = tpk.tile_pool_bwd_plain(t(g), t(vals), t(out), t(cells), t(toff), "max").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if ties:  # the whole sum to every tied row (pool2's rule) is not K10's
        whole, _ = emulate_runs(g, cells, mask, ncell, "sum", (vals, out), toff=toff)
        assert not np.allclose(whole, want, **TOL)


def test_k10_launches_the_run_kernel():
    """K10's wrapper launches ``t2h_pool_runs`` with the tile offsets and no
    mask; ``csrc/tile_pool.cu`` and its entry are gone."""
    import inspect

    from tomosar2height_tpu_torch.ops.cuda import runtime

    src = inspect.getsource(tpk.tile_pool)
    assert "t2h_pool_runs" in src and "tile_offsets.data_ptr()" in src
    assert "t2h_tile_pool" not in runtime._SIGNATURES
    assert not os.path.exists(os.path.join(os.path.dirname(SOURCE), "tile_pool.cu"))
    body = open(SOURCE).read()
    body = body[body.index("pool_runs(const T*"):body.index("// K2 alone")]
    assert "TILED" in body and "in_tile(" in body


# --- K2 alone: scatter_plane2's backward -----------------------------------------


def emulate_gather(g_plane, cells, mask, counts, mutant=None):
    """``pool_gather`` in numpy, warp by warp: returns (out, writes, loads),
    writes counting how often each row was stored and loads how many plane
    rows were read. g_plane (B, reso, reso, F) and counts (B, reso, reso)
    row-major. ``mutant``: 'stale' loads at the span's first valid row only
    (every later row reuses it across cell changes), 'prev_row' compares a
    row's cell with the previous row's whether or not that row is valid."""
    b, reso, _, f = g_plane.shape
    ncell = reso * reso
    n = cells.shape[1]
    flat, cnt = g_plane.reshape(b, ncell, f), counts.reshape(b, ncell)
    out = np.full((b, n, f), np.nan, np.float32)
    writes = np.zeros((b, n), np.int64)
    loads = 0
    for i in range(b):
        def dst(r):  # lane r's row-major cell, -1 where the row is not valid
            c = int(cells[i, r])
            return rowmajor(c, reso) if mask[i, r] and 0 <= c < ncell else -1

        for s0 in range(0, n, SPAN):
            rows = range(s0, min(s0 + SPAN, n))
            d = [dst(r) for r in rows]
            cur, last = np.zeros(f, np.float32), None
            for k, r in enumerate(rows):
                if mutant == "prev_row":
                    c = int(cells[i, r - 1]) if k else -1
                    last = rowmajor(c, reso) if k and 0 <= c < ncell else None
                if d[k] >= 0 and (last is None or (d[k] != last and mutant != "stale")):
                    cur = flat[i, d[k]] / np.float32(max(int(cnt[i, d[k]]), 1))
                    loads += 1
                if d[k] >= 0:
                    last = d[k]
                out[i, r] = cur if d[k] >= 0 else 0
                writes[i, r] += 1
    return out, writes, loads


def _gather_args(layout, seed=7):
    """(g_plane, cells, mask, counts) on a layout: the forward's counts, a
    random cotangent plane."""
    _, mask, cells, _, vals = layout
    counts = pk.scatter_plane2_plain(t(vals), t(cells), t(mask), RESO)[1].numpy()
    g = np.random.default_rng(seed).normal(size=(mask.shape[0], RESO, RESO, vals.shape[-1]))
    return g.astype(np.float32), cells, mask, counts


def unsorted(layout, seed=8):
    """The layout's rows in a random order within each entry."""
    pts, mask, cells, toff, vals = layout
    order = np.stack([np.random.default_rng(seed + i).permutation(mask.shape[1])
                      for i in range(mask.shape[0])])

    def take(x):
        return np.take_along_axis(x, order.reshape(order.shape + (1,) * (x.ndim - 2)), 1)

    return take(pts), take(mask), take(cells), toff, take(vals)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_gather_emulation_matches_plain(layout, order):
    """Runs across span edges, a 300-row cell, masked rows inside runs
    ('holes'), pads and an empty entry; and the same rows unsorted, which
    load more often and give the same result. Every row written once; the
    division is the plain version's, so the result is its bits."""
    lay = layout if order == "sorted" else unsorted(layout)
    g, cells, mask, counts = _gather_args(lay)
    got, writes, loads = emulate_gather(g, cells, mask, counts)
    assert (writes == 1).all()
    want = pk.scatter_plane2_bwd_plain(t(g), t(cells), t(mask), t(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == 0).all() and (got[-1] == 0).all()
    _, _, sorted_loads = emulate_gather(*_gather_args(layout))
    m = layout[1]
    spans = sum(np.count_nonzero(m[:, s:s + SPAN].any(axis=1)) for s in range(0, m.shape[1], SPAN))
    assert spans <= sorted_loads < int(m.sum())  # a run inside a span reads its cell once
    if order == "unsorted":
        assert loads > sorted_loads


def test_gather_emulation_matches_jax_vjp():
    """The vjp of the JAX ``scatter_plane2`` (its gather kernel in interpret
    mode), on the aligned layout proper (the JAX forward counts rows by cell
    id, so no holes)."""
    _, mask, cells, toff, vals = layout_ = run_batch(3)
    g, _, _, counts = _gather_args(layout_)
    ct, _ = chunk_metadata(jnp.asarray(toff), mask.shape[1], RESO, RESO)
    cells_row = make_cells_row(jnp.asarray(cells))
    tmask = empty_tile_mask(jnp.asarray(toff), RESO, RESO)
    _, vjp = jax.vjp(lambda v: jax_scatter_plane2(v, cells_row, ct, tmask, jnp.asarray(mask),
                                                  RESO), jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(g))
    got, _, _ = emulate_gather(g, cells, mask, counts)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("mutant", ["stale", "prev_row"])
def test_gather_mutants_fail(mutant):
    """Reusing the loaded value across a cell change ('stale'), or deciding
    the reuse on the previous row even where that row is masked ('prev_row':
    a run whose head is cleared then takes the run before it), leaves the
    plain version."""
    g, cells, mask, counts = _gather_args(run_batch(3, holes=True))
    got, _, _ = emulate_gather(g, cells, mask, counts, mutant)
    want = pk.scatter_plane2_bwd_plain(t(g), t(cells), t(mask), t(counts)).numpy()
    assert not np.allclose(got, want, **TOL)


def test_gather_source_matches_the_emulation():
    """K2 alone runs on the span partition: no atomic, no element loop with
    64-bit divides, the reuse decided on the previous valid row; its wrapper
    launches ``t2h_pool_gather`` (``t2h_pool_gather_bf16`` in bf16)."""
    import inspect

    src = open(SOURCE).read()
    body = src[src.index("pool_gather(const T*"):src.index("// A row's cell at this")]
    assert "atomic" not in body and "long long t" not in body and "grid_for" not in body
    assert "__shfl_sync(kFull, dst, below" in body and "dprev != dst" in body
    assert 'entry("pool_gather"' in inspect.getsource(pk.scatter_plane2_bwd)
