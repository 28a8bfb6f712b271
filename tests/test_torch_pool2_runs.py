"""The partition of ``pool2``'s run kernel (``csrc/pool2.cu`` ``pool_runs``),
emulated in numpy step by step as the kernel takes it: warps own 32-row spans
(``SPAN``, the kernel's ``kSpan``), a run belongs to the warp whose span holds its
head, a segmented scan in row order reduces each run, the last run reads on
past the span to its end, and a backward fill hands each row its run's result.
The emulation is held to the plain versions (``pool2_plain``,
``pool2_bwd_plain``) and through them to the JAX ``pool2`` and its vjp (Pallas
in interpret mode), on layouts from ``host_morton_bucket_aligned`` made to hit
the partition's edges (``test_torch_cuda.run_batch``): a cell of 300 rows,
runs straddling every span edge, a batch entry with no valid row, ties in max,
every tile padded, and rows cleared from the mask inside a run. Each row must
be written exactly once. Tolerance 1e-5 abs + rel (the kernel sums in row
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
from tomosar2height_tpu.ops.pallas.pool2_kernel import pool2 as jax_pool2  # noqa: E402
from test_torch_cuda import RESO, run_batch, t  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NCELL = RESO * RESO
SPAN = 32  # rows a warp owns: kSpan in csrc/pool2.cu
SOURCE = os.path.join(os.path.dirname(pk.__file__), "..", "..", "csrc", "pool2.cu")


def emulate_runs(x, cells, mask, ncell, kind, tie=None, span=SPAN):
    """The run kernel in numpy, warp by warp: returns (out, writes), writes
    counting how often each row was stored. x (B, N, F) f32; kind 'max' |
    'mean' | 'sum'; tie (values, out) gates a sum as max pooling's backward."""
    b, n, _ = x.shape
    out = np.full_like(x, np.nan)
    writes = np.zeros((b, n), np.int64)
    ident = np.float32(-np.inf if kind == "max" else 0.0)
    comb = np.maximum if kind == "max" else np.add

    def finalize(a, count):  # a run with no valid row gives no row its value
        return a / np.float32(max(count, 1)) if kind == "mean" else a

    def gated(r, row, i):
        return r if tie is None else np.where(tie[0][i, row] == tie[1][i, row], r, 0)

    for i in range(b):
        def cell(r):
            return int(cells[i, r]) if 0 <= r < n else -1

        for s0 in range(0, n, span):
            rows = range(s0, s0 + span)
            ok = [0 <= cell(r) < ncell for r in rows]
            heads = [ok[k] and cell(r - 1) != cell(r) for k, r in enumerate(rows)]
            valid = [ok[k] and bool(mask[i, r]) for k, r in enumerate(rows)]
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
            if cont:
                j = s0 + span
                while cell(j) == cell(s0 + span - 1):
                    tail.append(j)
                    j += 1
                for j in tail:
                    if mask[i, j]:
                        acc = comb(acc, x[i, j])
            # backward fill
            cur = np.zeros(x.shape[-1], np.float32)
            for k in reversed(range(span)):
                r = s0 + k
                if ok[k] and (cell(r + 1) != cell(r) or k == span - 1):
                    hs = [h for h in range(k + 1) if heads[h]]
                    count = sum(own[hs[-1]:k + 1]) if hs else 0
                    a = v[k]
                    if k == span - 1 and cont:
                        a = acc
                        count += int(mask[i, tail].sum())
                    cur = finalize(a, count)
                v[k] = cur
            # store: own rows and rows that are not valid; then the tail
            for k, r in enumerate(rows):
                if r >= n or (valid[k] and not own[k]):
                    continue
                out[i, r] = gated(v[k], r, i) if own[k] else 0
                writes[i, r] += 1
            for j in tail:
                if mask[i, j]:
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
    body = src[src.index("pool_runs(const float*"):src.index("__global__ void pool_gather")]
    assert "atomic" not in body
    assert "t2h_pool_reduce" not in src  # the cell-buffer reduce is retired
