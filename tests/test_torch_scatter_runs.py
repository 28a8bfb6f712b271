"""The run scatter (``csrc/pool2.cu`` ``scatter_runs``: K3 ``scatter_plane2``,
K11 ``scatter_mean_plane``, K12 ``aligned_scatter_mean_plane`` and K13
``scatter_mean``, which stores each cell at its Morton index), emulated
in numpy step by step as the kernel takes it: the flags are cleared; the
mark pass sets the flag of every cell that holds a valid row; in the run
part, warps own 32-row spans (``SPAN``, the kernel's ``kSpan``), a run
belongs to the warp whose span holds its head, a segmented scan in row order
sums each run, the last run reads on past the span to its end, and each run
with a valid row writes its cell's mean (and count, K3) once; the zero part
writes 0 to every cell whose flag is clear. The emulation is held to the
plain versions (``scatter_plane2_plain``, ``scatter_mean_plane_plain``,
``aligned_scatter_mean_plane_plain``, ``scatter_mean_plain``) and through
them to the JAX ``scatter_plane2``, ``pallas_scatter_mean_plane``,
``pallas_aligned_scatter_mean_plane`` and ``pallas_scatter_mean`` (Pallas in
interpret mode), on layouts
made to hit the partition's edges (``test_torch_cuda.run_batch``,
``tile_run_batch``, ``sorted_run_batch``): a cell of 300 rows, runs
straddling every span edge, a batch entry with no valid row, every tile
padded, rows cleared from the mask inside a run (K3), rows of another tile
(K11, K12), a row past the last tile (K11), the fused layout's levels from
256^2 down to 16^2 (K12) and the plain sorted layout's, its ids shifted and
its per-cell offsets strided as ``chip_smoke.check_tile_kernels`` does (K11,
which reads every 256th offset: the tile-offset step; K13 on the same).
Since the bf16 redesign the emulation runs on ``tile_plan.scatter_runs_plan``'s
lanes (16 bytes a lane from F = 256 in bf16) and 16-byte zero items, and
bf16 values are held to the plain version and JAX's K3 within a bf16 ulp.
Every plane value must be written exactly once, and a mutant of the read-on,
of the zero pass, of K11's step or of K13's order (flags in one order, the
store in the other) must fail. Tolerance 1e-5 abs + rel (the kernel sums in row
order, the plain version in scatter order)."""

from __future__ import annotations

import inspect
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.ops.pallas.level_kernel import (  # noqa: E402
    chunk_metadata,
    empty_tile_mask,
    make_cells_row,
)
from tomosar2height_tpu.ops.pallas.pool2_kernel import (  # noqa: E402
    scatter_plane2 as jax_scatter_plane2,
)
from tomosar2height_tpu.ops.pallas.scatter_kernel import (  # noqa: E402
    pallas_aligned_scatter_mean_plane,
    pallas_scatter_mean,
    pallas_scatter_mean_plane,
    pallas_scatter_mean_plane_v3,
)
from test_torch_cuda import (  # noqa: E402
    FINEST,
    RESO,
    run_batch,
    sorted_run_batch,
    t,
    tile_run_batch,
)
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import tile_plan as tp  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import PAD_CELL_SENTINEL  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SPAN = 32  # rows a warp owns: kSpan in csrc/pool2.cu
LEVELS = (256, 128, 64, 32, 16)
SOURCE = os.path.join(os.path.dirname(pk.__file__), "..", "..", "csrc", "pool2.cu")


def _bf16(a):
    """float32 values rounded to bf16 (ties to even) and back."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _compact(v):
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF


def rowmajor(code, reso):
    """morton_to_rowmajor of csrc/common.cuh."""
    return _compact(code >> 1) * reso + _compact(code)


def emulate_scatter(x, cells, reso, mask=None, toff=None, shift=0, step=1, morton=False,
                    mutant=None, elem=4):
    """The steps of ``t2h_scatter_runs`` in numpy: K3 with ``mask``; K11-K13
    with ``toff``, tile t of entry i spanning rows [toff[i, t * step],
    toff[i, (t + 1) * step]) (K12: tile offsets at ``reso``, step 1; K11,
    K13: per-cell offsets, step 256), and ``shift``; on the lanes and items
    of ``tile_plan.scatter_runs_plan`` for values of ``elem`` bytes (2: x
    holds bf16 values, each mean rounded to bf16 once). Returns (plane (B,
    reso, reso, F), counts (B, reso, reso), writes (B, reso, reso, F): how
    often each plane value was stored); with ``morton`` (K13) the flags and
    the output are in Morton order, (B, reso**2, F), (B, reso**2), (B,
    reso**2, F). ``mutant``: 'no_read_on' drops the walk past the span,
    'no_zero_pass' the zero pass, 'no_step' reads the tile offsets with step
    1 whatever ``step`` says, 'mixed_order' stores row-major while the flags
    are in ``morton``'s order."""
    b, n, f = x.shape
    ncell = reso * reso
    plan = tp.scatter_runs_plan(f, elem)
    plane = np.full((b, ncell, f), np.nan, np.float32)
    counts = np.full((b, ncell), -1, np.int64)
    writes = np.zeros((b, ncell, f), np.int64)
    flags = np.zeros((b, ncell), bool)  # cleared
    raw = cells.astype(np.int64)
    key = np.where((raw >= 0) & ((raw >> shift) < ncell), raw >> shift, -1)
    # key of row r at [i, r + 1]: -1 before the entry and past it
    keys = np.concatenate([np.full((b, 1), -1), key, np.full((b, SPAN + 1), -1)], axis=1)

    # the run part's lanes: chunk fc, lane l store features (32 fc + l) vec onwards
    cover = np.zeros(f, np.int64)
    vec = plan["vec"]
    for fc in range(plan["chunks"]):
        for lane in range(32):
            f0 = (32 * fc + lane) * vec
            if f0 < f:
                assert f0 + vec <= f  # a lane's bytes inside its row
                cover[f0:f0 + vec] += 1

    st = 1 if mutant == "no_step" else step

    def index(c, store=False):  # a cell's place in the flags and the output
        return int(c) if morton and not (store and mutant == "mixed_order") else rowmajor(
            int(c), reso)

    def valid(i, r, c):
        if toff is None:
            return bool(mask[i, r])
        return toff[i, (c >> 8) * st] <= r < toff[i, ((c >> 8) + 1) * st]

    def mean(total, count):
        m = (total / np.float32(count)).astype(np.float32)
        return m if elem == 4 else _bf16(m)

    for i in range(b):  # the mark pass, a row at a time
        for r in np.flatnonzero(key[i] >= 0):
            if valid(i, r, key[i, r]):
                flags[i, index(key[i, r])] = True
    for i in range(b):  # the run part, warp by warp
        for s0 in range(0, n, SPAN):
            ks = keys[i, s0:s0 + SPAN + 2]
            c, prev, nxt = ks[1:-1], ks[:-2], ks[2:]
            heads = (c >= 0) & (prev != c)
            if not heads.any():
                continue  # every run here is an earlier warp's
            first = int(np.argmax(heads))
            acc, cnt, sums, cnts = np.zeros(f, np.float32), 0, [], []
            for k in range(SPAN):  # segmented scan in row order
                if heads[k]:
                    acc, cnt = np.zeros(f, np.float32), 0
                if k >= first and c[k] >= 0 and valid(i, s0 + k, c[k]):
                    acc, cnt = acc + x[i, s0 + k], cnt + 1
                sums.append(acc)
                cnts.append(cnt)
            cont = c[-1] >= 0 and nxt[-1] == c[-1]
            if cont and mutant != "no_read_on":  # the last run past the span
                j = s0 + SPAN
                while keys[i, j + 1] == c[-1]:
                    if valid(i, j, c[-1]):
                        acc, cnt = acc + x[i, j], cnt + 1
                    j += 1
            for k in range(first, SPAN):  # each own run's end: its cell, once
                if c[k] < 0 or (nxt[k] == c[k] and k < SPAN - 1):
                    continue
                last = k == SPAN - 1 and cont
                total, count = (acc, cnt) if last else (sums[k], cnts[k])
                if count == 0:
                    continue
                dst = index(c[k], store=True)
                plane[i, dst] = mean(total, count)
                counts[i, dst] = count
                writes[i, dst] += cover
    if mutant != "no_zero_pass":  # the zero part: the cells whose flag is clear
        _zero_part(plane.reshape(b * ncell, f), counts.reshape(-1), writes.reshape(b * ncell, f),
                   flags.reshape(-1), plan, mutant)
    if morton:
        return plane, counts, writes
    return (plane.reshape(b, reso, reso, f), counts.reshape(b, reso, reso),
            writes.reshape(b, reso, reso, f))


def _zero_part(plane, counts, writes, flags, plan, mutant=None):
    """The zero part on the plan's items (``item`` values each, ``q`` a
    cell, each loading its cell's flag): 0 to every value of every cell
    whose flag is clear, and its count."""
    q, item = plan["q"], plan["item"]
    i = np.arange(flags.size * q)
    cell = i // q
    empty = np.flatnonzero(~flags[cell])
    for e in range(item):
        feat = (empty % q) * item + e
        plane[cell[empty], feat] = 0
        np.add.at(writes, (cell[empty], feat), 1)
    counts[cell[empty[empty % q == 0]]] = 0


def level_sorted(cells, offs, reso):
    """K11's arguments at ``reso``: ids shifted, per-cell offsets strided."""
    shift = level_shift(reso)
    return np.ascontiguousarray(cells >> shift), np.ascontiguousarray(offs[:, :: 4 ** (shift // 2)])


def level_toff(toff, reso):
    return np.ascontiguousarray(toff[:, :: 4 ** (FINEST.bit_length() - reso.bit_length())])


def level_shift(reso):
    return 2 * (FINEST.bit_length() - reso.bit_length())


def _scatter_k3(vals, cells, mask, mutant=None):
    return emulate_scatter(vals, cells, RESO, mask=mask, mutant=mutant)


def _scatter_k12(vals, cells, toff, reso, mutant=None):
    return emulate_scatter(vals, cells, reso, toff=level_toff(toff, reso),
                           shift=level_shift(reso), mutant=mutant)


def _scatter_k11(vals, cells, offs, reso, mutant=None, morton=False):
    c, o = level_sorted(cells, offs, reso)
    return emulate_scatter(vals, c, reso, toff=o, step=256, morton=morton, mutant=mutant)


def _k11_plain(vals, cells, offs, reso):
    c, o = level_sorted(cells, offs, reso)
    return sk.scatter_mean_plane_plain(t(vals), t(c), t(o), reso).numpy()


def _runs_per_cell(key):
    """{cell: number of runs} of one entry's row keys (-1 out of range)."""
    heads = np.flatnonzero((key >= 0) & np.r_[True, key[1:] != key[:-1]])
    return np.bincount(key[heads])


@pytest.fixture(scope="module", params=[False, True], ids=["aligned", "holes"])
def k3_layout(request):
    return run_batch(3, holes=request.param)


@pytest.fixture(scope="module")
def k12_layout():
    return tile_run_batch(11)


@pytest.fixture(scope="module")
def k11_layout():
    return sorted_run_batch(13)


def test_layouts_reach_the_partition_edges(k12_layout):
    _, mask, cells, toff, _ = k12_layout
    ok = cells < PAD_CELL_SENTINEL
    edges = [s for s in range(SPAN, cells.shape[1], SPAN)
             if ok[0, s] and cells[0, s] == cells[0, s - 1]]
    assert len(edges) >= 26  # runs of 37 rows straddle every span edge of tile 0
    assert np.bincount(cells[0][mask[0]]).max() == 300
    used = np.diff(toff[:3], axis=1)
    assert ((used % 128) == 0).all() and (used > 0).sum() >= 3
    for i in range(3):  # every used tile ends in pad rows
        for lo, hi in zip(toff[i], toff[i, 1:]):
            if hi > lo:
                assert cells[i, hi - 1] == PAD_CELL_SENTINEL or mask[i, lo:hi].all()
    assert not mask[3].any()
    _, _, fcells, _, _ = tile_run_batch(11, foreign=True)
    assert (fcells != cells).sum() >= 10


@pytest.mark.parametrize("reso", LEVELS)
def test_fused_layout_holds_one_run_per_cell(k12_layout, reso):
    """On the fused layout every occupied cell at every level down to 16^2 is
    one run (a coarse cell lies inside one finest tile, pads only at its
    ends): the run kernel's contract. At 16^2 a cell is a whole finest tile."""
    _, mask, cells, _, _ = k12_layout
    for i in range(mask.shape[0]):
        key = np.where(mask[i], cells[i].astype(np.int64) >> level_shift(reso), -1)
        key = np.where(cells[i] < PAD_CELL_SENTINEL, key, -1)
        runs = _runs_per_cell(key)
        assert (runs <= 1).all(), reso
    if reso == 16:  # entry 0's tile 0 is one run of 888+ rows, across 28 spans
        key = np.where(mask[0], cells[0] >> 8, -1)
        assert np.count_nonzero(key == 0) >= 888 and _runs_per_cell(key)[0] == 1


def test_k3_emulation_matches_plain(k3_layout):
    _, mask, cells, _, vals = k3_layout
    got, counts, writes = _scatter_k3(vals, cells, mask)
    assert (writes == 1).all()  # every plane cell stored once
    want, want_counts = pk.scatter_plane2_plain(t(vals), t(cells), t(mask), RESO)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    np.testing.assert_array_equal(counts, want_counts.numpy())
    assert (got[-1] == 0).all() and (counts[-1] == 0).all()  # the empty entry


@pytest.mark.parametrize("reso,foreign", [(r, False) for r in LEVELS]
                         + [(r, True) for r in LEVELS if r >= 32])
def test_k12_emulation_matches_plain(k12_layout, reso, foreign):
    """Every level of the fused layout; with rows of another tile down to
    32^2 (16^2 is one tile, where no row lies in another)."""
    _, _, cells, toff, vals = tile_run_batch(11, foreign=True) if foreign else k12_layout
    got, _, writes = _scatter_k12(vals, cells, toff, reso)
    assert (writes == 1).all()
    want = sk.aligned_scatter_mean_plane_plain(t(vals), t(cells), t(level_toff(toff, reso)),
                                               reso, FINEST)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    assert (got[-1] == 0).all()


def test_k3_emulation_matches_jax_scatter_plane2():
    """On the aligned layout proper (the JAX kernel masks rows by ``mask``)."""
    _, mask, cells, toff, vals = run_batch(3)
    ct, _ = chunk_metadata(jnp.asarray(toff), mask.shape[1], RESO, RESO)
    want = np.asarray(jax_scatter_plane2(
        jnp.asarray(vals), make_cells_row(jnp.asarray(cells)), ct,
        empty_tile_mask(jnp.asarray(toff), RESO, RESO), jnp.asarray(mask), RESO))
    got, _, _ = _scatter_k3(vals, cells, mask)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reso", [32, 16])
def test_k12_emulation_matches_jax(k12_layout, reso):
    """The Pallas kernel in interpret mode at the coarse levels, where runs
    are longest."""
    _, _, cells, toff, vals = k12_layout
    want = np.asarray(pallas_aligned_scatter_mean_plane(
        jnp.asarray(vals), jnp.asarray(cells.reshape(cells.shape[0], -1, 128)),
        jnp.asarray(level_toff(toff, reso)), reso, FINEST, interpret=True))
    got, _, _ = _scatter_k12(vals, cells, toff, reso)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mutant", ["no_read_on", "no_zero_pass"])
def test_mutants_fail(k3_layout, k12_layout, mutant):
    """Without the walk past the span, runs longer than their head's span
    lose rows; without the zero pass, empty cells are never written."""
    _, mask, cells, _, vals = k3_layout
    got, _, writes = _scatter_k3(vals, cells, mask, mutant)
    want = pk.scatter_plane2_plain(t(vals), t(cells), t(mask), RESO)[0].numpy()
    assert (writes != 1).any() or not np.allclose(got, want, **TOL)
    _, _, cells, toff, vals = k12_layout
    got, _, writes = _scatter_k12(vals, cells, toff, 16, mutant)
    want = sk.aligned_scatter_mean_plane_plain(t(vals), t(cells), t(level_toff(toff, 16)), 16,
                                               FINEST).numpy()
    assert (writes != 1).any() or not np.allclose(got, want, **TOL)


def test_emulation_sums_in_row_order(k3_layout):
    """A run's mean is its float32 left fold in row order over its count, so
    the kernel's result is fixed; the 300-row run shows it."""
    _, mask, cells, _, vals = k3_layout
    cell = np.bincount(cells[1][mask[1]]).argmax()
    rows = np.flatnonzero(mask[1] & (cells[1] == cell))
    fold = np.zeros(vals.shape[-1], np.float32)
    for r in rows:
        fold = fold + vals[1, r]
    got, counts, _ = _scatter_k3(vals, cells, mask)
    y, x = divmod(rowmajor(int(cell), RESO), RESO)
    assert counts[1, y, x] == rows.size
    np.testing.assert_array_equal(got[1, y, x], fold / np.float32(rows.size))


def test_kernel_source_matches_the_emulation():
    """The emulated span is the kernel's; the run scatter adds with no atomic,
    and the atomic plane scatter is gone; the kernel takes its lanes, groups
    and zero items from the plan that ``tile_plan.scatter_runs_plan`` mirrors
    (checked against the C side at each wrapper's first launch), its groups
    32 registers of values, bf16 kept as raw words, two to a register."""
    src = open(SOURCE).read()
    assert f"constexpr int kSpan = {SPAN};" in src and tp.SPAN == SPAN
    body = src[src.index("scatter_runs(const float*"):src.index("}  // namespace t2h")]
    assert "atomic" not in body
    launch = src[src.index("int launch_scatter_runs("):src.index("}  // namespace t2h")]
    assert "runs_plan(F, sizeof(T), aligned16(values))" in launch and "p.vec == 8" in launch
    assert "constexpr int kVec = 16 / sizeof(T);" in src  # 16-byte zero items
    assert "static constexpr int kRegs = VEC == 1 ? 1 : VEC / 2;" in src  # bf16 raw words
    assert "32 / RowVals<T, VEC>::kRegs" in src
    assert "runs_plan(f, values.element_size()" in inspect.getsource(pk.scatter_runs_masked)
    assert "runs_plan(f, values.element_size()" in inspect.getsource(sk._scatter_runs)
    assert "scatter_plane_accum" not in src and "t2h_scatter_plane(" not in src
    assert "scatter_runs_masked(" in inspect.getsource(pk._scatter_plane2)
    assert "t2h_scatter_runs" in inspect.getsource(pk.scatter_runs_masked)
    assert "t2h_scatter_runs" in inspect.getsource(sk._scatter_runs)
    for wrapper, step in ((sk.scatter_mean_plane, "TILE_CELLS)"),
                          (sk.aligned_scatter_mean_plane, ", 1, with_counts")):
        src = inspect.getsource(wrapper)
        assert "_scatter_runs(" in src and step in src and "t2h_tile_scatter_mean" not in src


def test_sorted_layout_reaches_the_partition_edges(k11_layout):
    """K11's layout: pads only at the end, runs across every span edge of
    entry 0's tile 0, a 300-row cell, an entry with pads, an empty entry;
    the moved rows lie in the first quarter and hold cells of the last."""
    vals, cells, offs = k11_layout
    ncell = FINEST * FINEST
    for i in range(4):
        assert (np.diff(cells[i]) >= 0).all()  # Morton-sorted, pads last
        assert (cells[i, offs[i, -1]:] == ncell).all() and (cells[i, :offs[i, -1]] < ncell).all()
    edges = [s for s in range(SPAN, offs[0, -1], SPAN) if cells[0, s] == cells[0, s - 1]]
    assert len(edges) >= 26
    assert np.bincount(cells[0]).max() == 300
    assert 0 < offs[1, -1] < cells.shape[1] and offs[3, -1] == 0
    _, mcells, _ = sorted_run_batch(13, moved=True)
    changed = np.argwhere(mcells != cells)
    assert len(changed) >= 10
    for i, r in changed:
        if r < offs[i, -1]:
            assert mcells[i, r] >= 3 * ncell // 4 and r < offs[i, 64 * 256]
        else:
            assert r == cells.shape[1] - 1 and mcells[i, r] < 256


@pytest.mark.parametrize("reso", LEVELS)
def test_sorted_layout_holds_one_run_per_cell(k11_layout, reso):
    """On the plain sorted layout every occupied cell at every level is one
    run: the run kernel's contract."""
    _, cells, offs = k11_layout
    c, _ = level_sorted(cells, offs, reso)
    for key in np.where(c < reso * reso, c, -1).astype(np.int64):
        assert (_runs_per_cell(key) <= 1).all(), reso


@pytest.mark.parametrize("reso,moved", [(r, False) for r in LEVELS]
                         + [(r, True) for r in LEVELS if r >= 32])
def test_k11_emulation_matches_plain(k11_layout, reso, moved):
    """K11 at every level of the plain sorted layout, tile offsets every
    256th per-cell offset; with rows out of their tile and a row past the
    last tile down to 32^2 (16^2 is one tile, where a moved row would split
    its cell's run)."""
    vals, cells, offs = sorted_run_batch(13, moved=True) if moved else k11_layout
    got, _, writes = _scatter_k11(vals, cells, offs, reso)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, _k11_plain(vals, cells, offs, reso), **TOL)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("reso,moved", [(32, False), (16, False), (32, True)])
def test_k11_emulation_matches_jax(reso, moved):
    """The Pallas kernel in interpret mode at the coarse levels, where runs
    are longest; its 128-row chunk windows see the moved rows in no tile of
    their cells."""
    vals, cells, offs = sorted_run_batch(13, moved=moved)
    c, o = level_sorted(cells, offs, reso)
    want = np.asarray(pallas_scatter_mean_plane(jnp.asarray(vals), jnp.asarray(c),
                                                jnp.asarray(o), reso, interpret=True))
    got, _, _ = _scatter_k11(vals, cells, offs, reso)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mutant", ["no_read_on", "no_zero_pass", "no_step"])
def test_k11_mutants_fail(k11_layout, mutant):
    """K11 at 64^2 (runs past their span: 37-row cells) and 16^2: without the
    walk past the span, the zero pass, or the step of 256 (tile t's rows
    taken from cell t's offsets), the emulation leaves the plain version."""
    vals, cells, offs = k11_layout
    failed = []
    for reso in (64, 16):
        got, _, writes = _scatter_k11(vals, cells, offs, reso, mutant)
        want = _k11_plain(vals, cells, offs, reso)
        failed.append((writes != 1).any() or not np.allclose(got, want, **TOL))
    assert any(failed)


# --- K13: K11's function into the Morton-ordered cell vector ----------------------


def _k13_plain(vals, cells, offs, reso):
    c, o = level_sorted(cells, offs, reso)
    return sk.scatter_mean_plain(t(vals), t(c), t(o), reso).numpy()


@pytest.mark.parametrize("reso,moved", [(r, False) for r in LEVELS]
                         + [(r, True) for r in LEVELS if r >= 32])
def test_k13_emulation_matches_plain(k11_layout, reso, moved):
    """K13 at every level of the plain sorted layout, as K11 (tile offsets
    every 256th per-cell offset; rows out of their tile and a row past the
    last tile down to 32^2), each cell stored at its Morton index."""
    vals, cells, offs = sorted_run_batch(13, moved=True) if moved else k11_layout
    got, _, writes = _scatter_k11(vals, cells, offs, reso, morton=True)
    assert got.shape == (4, reso * reso, vals.shape[-1])
    assert (writes == 1).all()
    np.testing.assert_allclose(got, _k13_plain(vals, cells, offs, reso), **TOL)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("reso,moved", [(32, False), (16, False), (32, True)])
def test_k13_emulation_matches_jax(reso, moved):
    """``pallas_scatter_mean`` in interpret mode at the coarse levels."""
    vals, cells, offs = sorted_run_batch(13, moved=moved)
    c, o = level_sorted(cells, offs, reso)
    want = np.asarray(pallas_scatter_mean(jnp.asarray(vals), jnp.asarray(c), jnp.asarray(o),
                                          reso, interpret=True))
    got, _, _ = _scatter_k11(vals, cells, offs, reso, morton=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reso", [256, 32])
def test_k13_mixed_order_fails(k11_layout, reso):
    """Flags in Morton order but the means stored row-major: the zero part
    then clears occupied cells and leaves others unwritten."""
    vals, cells, offs = k11_layout
    got, _, writes = _scatter_k11(vals, cells, offs, reso, "mixed_order", morton=True)
    assert (writes != 1).any()
    assert not np.allclose(got, _k13_plain(vals, cells, offs, reso), **TOL)


def test_k13_launches_the_run_kernel():
    """K13's wrapper launches ``t2h_scatter_runs`` with the step of 256 and
    the Morton-order store (flags and output (B, reso**2)); no wrapper is
    left on ``t2h_tile_scatter_mean``, whose file went with K14; the store
    index is the mark pass's."""
    src = inspect.getsource(sk.scatter_mean)
    assert "_scatter_runs(" in src and "TILE_CELLS" in src and "morton=True" in src
    assert "t2h_tile_scatter_mean" not in src and "_launch(" not in src
    assert "int(morton)" in inspect.getsource(sk._scatter_runs)
    assert "t2h_tile_scatter_mean" not in inspect.getsource(sk)
    body = open(SOURCE).read()
    mark = body[body.index("void mark_cells("):body.index("void store_mean(")]
    runs = body[body.index("scatter_runs(const T*"):body.index("int launch_pool_runs(")]
    assert "MORTON ? c : morton_to_rowmajor(c, reso)" in mark
    assert "MORTON ? c : morton_to_rowmajor(c, reso)" in runs
    assert not os.path.exists(os.path.join(os.path.dirname(SOURCE), "tile_scatter.cu"))


# --- K14: K12's function from the finest tile offsets, read every 4**level-th ------


def _scatter_k14(vals, cells, toff, reso, mutant=None):
    shift = level_shift(reso)
    return emulate_scatter(vals, cells, reso, toff=toff, shift=shift, step=4 ** (shift // 2),
                           mutant=mutant)


@pytest.mark.parametrize("reso,foreign", [(r, False) for r in LEVELS]
                         + [(r, True) for r in LEVELS if r >= 32])
def test_k14_emulation_matches_plain(k12_layout, reso, foreign):
    """K14 at every level of the fused layout, the finest tile offsets read
    in place with a step of 4**level; with rows of another tile down to
    32^2."""
    _, _, cells, toff, vals = tile_run_batch(11, foreign=True) if foreign else k12_layout
    got, _, writes = _scatter_k14(vals, cells, toff, reso)
    assert (writes == 1).all()
    want = sk.scatter_mean_plane_v3_plain(t(vals), t(cells), t(toff), reso, FINEST)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("reso", [64, 32])
def test_k14_emulation_matches_jax(k12_layout, reso):
    """``pallas_scatter_mean_plane_v3`` in interpret mode at K14's coarse
    shapes, where runs are longest."""
    _, _, cells, toff, vals = k12_layout
    want = np.asarray(pallas_scatter_mean_plane_v3(
        jnp.asarray(vals), jnp.asarray(cells.reshape(cells.shape[0], -1, 128)),
        jnp.asarray(toff), reso, FINEST, interpret=True))
    got, _, _ = _scatter_k14(vals, cells, toff, reso)
    np.testing.assert_allclose(got, want, **TOL)


def test_k14_launches_the_run_kernel(k12_layout):
    """K14's wrapper launches ``t2h_scatter_runs`` with the step of
    4**level; read with step 1 (tile t's rows taken from finest tile t's
    offsets) the emulation leaves the plain version."""
    src = inspect.getsource(sk.scatter_mean_plane_v3)
    assert "_scatter_runs(" in src and "4 ** (shift // 2)" in src and "_launch(" not in src
    _, _, cells, toff, vals = k12_layout
    got, _, writes = _scatter_k14(vals, cells, toff, 32, "no_step")
    want = sk.scatter_mean_plane_v3_plain(t(vals), t(cells), t(toff), 32, FINEST).numpy()
    assert (writes != 1).any() or not np.allclose(got, want, **TOL)


# --- the bf16 instance: 16-byte lanes from F = 256 on, whole spans in flight ----------


def _ulp_close(got, want):
    """Within one bf16 ulp of ``want`` (floored at 2^-126): the run's row-order
    f32 sum against the plain version's scatter order, each rounded once."""
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    return bool((np.abs(got - want) <= ulp).all())


@pytest.mark.parametrize("reso,f", [(64, 64), (32, 256), (16, 512), (32, 1024)])
def test_k12_bf16_plan_emulation_matches_plain(reso, f):
    """K12 on bf16 values at the widths where the bf16 plan differs from
    f32's (8 features, 16 bytes, a lane from F = 256 on; two and four chunks
    a span at 512 and 1024): every plane value written once, by one lane or
    one zero item; within a bf16 ulp of the bf16 plain version."""
    _, _, cells, toff, vals = tile_run_batch(11, f=f)
    vals = _bf16(vals)
    got, _, writes = emulate_scatter(vals, cells, reso, toff=level_toff(toff, reso),
                                     shift=level_shift(reso), elem=2)
    assert (writes == 1).all()
    want = sk.aligned_scatter_mean_plane_plain(t(vals).to(torch.bfloat16), t(cells),
                                               t(level_toff(toff, reso)), reso, FINEST)
    assert _ulp_close(got, want.float().numpy())
    assert (got[-1] == 0).all()


def test_k3_bf16_plan_emulation_matches_jax():
    """K3 on bf16 values at F = 32 (a lane a feature, the span's 32 rows at
    once; zero items of 8 values) against the JAX kernel's bf16 rule in
    interpret mode (pool2_kernel.py:292-334): within a bf16 ulp."""
    _, mask, cells, toff, vals = run_batch(3, f=32)
    vals = _bf16(vals)
    ct, _ = chunk_metadata(jnp.asarray(toff), mask.shape[1], RESO, RESO)
    want = np.asarray(jax_scatter_plane2(
        jnp.asarray(vals, jnp.bfloat16), make_cells_row(jnp.asarray(cells)), ct,
        empty_tile_mask(jnp.asarray(toff), RESO, RESO), jnp.asarray(mask), RESO))
    got, _, writes = emulate_scatter(vals, cells, RESO, mask=mask, elem=2)
    assert (writes == 1).all()
    assert _ulp_close(got, want.astype(np.float32))


def test_scatter_runs_plan_widths():
    """Lane widths by bytes: bf16 8 features (16 bytes) a lane from F = 256
    on; f32 unchanged (4 from 128); a group of 128 bytes a lane (bf16 twice
    f32's rows at one width); zero items of 16 bytes, one value where F is
    no multiple of them; q and its shift; the C side's key order."""
    bf = {f: tp.scatter_runs_plan(f, 2) for f in (32, 64, 128, 256, 512, 1024)}
    assert [(p["vec"], p["chunks"], p["group"], p["q"]) for p in bf.values()] == [
        (1, 1, 32, 4), (2, 1, 32, 8), (4, 1, 16, 16), (8, 1, 8, 32), (8, 2, 8, 64),
        (8, 4, 8, 128)]
    f32 = {f: tp.scatter_runs_plan(f, 4) for f in (32, 64, 128, 256, 1024)}
    assert [(p["vec"], p["chunks"], p["group"], p["q"]) for p in f32.values()] == [
        (1, 1, 32, 8), (2, 1, 16, 16), (4, 1, 8, 32), (4, 2, 8, 64), (4, 8, 8, 256)]
    assert tp.scatter_runs_plan(512, 2, aligned=False)["vec"] == 1
    p = tp.scatter_runs_plan(20, 2)
    assert (p["item"], p["q"], p["qshift"]) == (1, 20, -1)
    p = tp.scatter_runs_plan(24, 2)
    assert (p["item"], p["q"], p["qshift"]) == (8, 3, -1)
    assert tuple(tp.SCATTER_RUNS_PLAN_KEYS) == tuple(p)
