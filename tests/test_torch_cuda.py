"""The PyTorch port's CUDA kernels K1-K14 against their plain versions, on the
card, forward and backward (K6-K12 backward: the plain composition's; K1 +
K2 are one run kernel on pool2's path, which also serves K10 under the tile
rule, K2 alone on scatter_plane2's backward, in any row order; K3 and
K11-K13 one run scatter, K13 storing in Morton order). Marked
``cuda``: they skip where no CUDA card is present (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine without it; there,
skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

It also holds the numpy input functions that ``test_torch_pool2*.py``,
``test_torch_level*.py`` and ``test_torch_tile_kernels.py`` feed to the JAX
package. Tolerance 1e-5 (rtol and atol): the kernels sum in another order
than the plain versions (the run kernels in row order, K5's d_plane pass in
its pixels' rectangle order), and every kernel is bit-equal run to run (no
atomics). K5's d_plane and d_c_last: 2e-5 abs + 2e-4 rel
(tests/test_fused_level_bwd.py); its weight gradients are sums over every
row, so 3e-4 * max|ref| abs + 3e-4 rel. The conv kernels K6-K8: 1e-5 abs +
rel (3xTF32 on the tensor cores, in another order than cuDNN's full-fp32
convolutions; K6's head in fp32 FMA). The backwards of K9/K10/K12 are the plain
composition's autograd: 1e-5. The port's own cuDNN convolutions run in full
float32 under PyTorch's default flags (TF32 on for cuDNN): held to float64.
K6-K8 on bf16 activations (one bf16 pass on the tensor cores): their
distance from the float64 evaluation of the same operands at most twice the
bf16 plain version's plus one bf16 ulp of the output's scale. K1-K5's bf16
instances: the run kernels, K2, K5's d_plane pass and weight sums within one
bf16 ulp of their bf16 plain versions (f32 sums in two orders, each output
rounded once; max exact); K4 and K5 under the JAX package's bf16 rule
(``bf16_level_held``). K9-K14's bf16 modes and the ``fused``/``cumsum``
backwards in bf16: within one bf16 ulp of their bf16 plain versions (max
and K12's backward bit-equal).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tomosar2height_tpu_torch.models.blocks import Conv3x3
from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk
from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk
from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk
from tomosar2height_tpu_torch.ops import fused
from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk
from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk
from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d
from tomosar2height_tpu_torch.ops.sorted_scatter import (
    PAD_CELL_SENTINEL,
    aligned_bucket_size,
    host_morton_bucket,
    host_morton_bucket_aligned,
    trim_aligned_batch,
)

RESO = 64
TOL = dict(rtol=1e-5, atol=1e-5)
FINEST = 256  # the fused layout's finest resolution, 256-cell tiles


def aligned_batch(seed: int, b: int = 3, n: int = 700, reso: int = RESO, f: int = 8):
    """b aligned patches; entry 0 has clustered points (ties, shared cells),
    the last entry is an empty patch (every row padding)."""
    rng = np.random.default_rng(seed)
    npad = aligned_bucket_size(n, reso)
    pts = np.full((b, npad, 3), 0.5, np.float32)
    mask = np.zeros((b, npad), bool)
    cells = np.zeros((b, npad), np.int32)
    toff = np.zeros((b, reso * reso // 1024 + 1), np.int32)
    for i in range(b):
        p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        m = rng.random(n) > 0.1
        if i == 0:
            p[: n // 2, :2] = rng.uniform(0.40, 0.45, (n // 2, 2))  # dense cells
        if i == b - 1:
            m[:] = False
        a = host_morton_bucket_aligned(p, m, reso)
        pts[i], mask[i], cells[i], toff[i] = a["points"], a["mask"], a["cells"], a["tile_offsets"]
    vals = rng.normal(size=(b, npad, f)).astype(np.float32)
    vals[0, 5:9] = vals[0, 5]  # exact ties inside a run
    vals = np.round(vals, 1)  # many ties between points of a cell
    return pts, mask, cells, toff, vals


def tied_batch(seed: int, b: int = 3, n: int = 600, reso: int = RESO, f: int = 8):
    """b aligned patches full of tied cell maxima: entry 0 crowds its points
    into a few cells and repeats one point ten times, every value is one of
    {0, 1, 2}; the last entry is an empty patch."""
    rng = np.random.default_rng(seed)
    npad = aligned_bucket_size(n, reso)
    pts = np.full((b, npad, 3), 0.5, np.float32)
    mask = np.zeros((b, npad), bool)
    cells = np.zeros((b, npad), np.int32)
    toff = np.zeros((b, reso * reso // 1024 + 1), np.int32)
    for i in range(b):
        p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        m = rng.random(n) > 0.1
        if i == 0:
            p[:, :2] = rng.uniform(0.30, 0.36, (n, 2))
            p[10:20] = p[10]  # duplicate points
            m[10:20] = True
        if i == b - 1:
            m[:] = False
        a = host_morton_bucket_aligned(p, m, reso)
        pts[i], mask[i], cells[i], toff[i] = a["points"], a["mask"], a["cells"], a["tile_offsets"]
    vals = rng.integers(0, 3, (b, npad, f)).astype(np.float32)
    return pts, mask, cells, toff, vals


def run_batch(seed: int, reso: int = RESO, f: int = 8, holes: bool = False):
    """Aligned patches built against the run kernel's partition into 32-row
    spans (``kSpan`` in ``csrc/pool2.cu``): entry 0 fills cells of
    tile 0 with 37 points each (runs longer than a span, and since 37 is prime
    to 32 a run straddles every span edge up to row 37 * cells) and puts a few
    points in every other tile, so every tile ends in pad rows; entry 1 puts
    300 points into one cell among scattered ones; entry 2 crowds its points
    into a few cells with values in {0, 1, 2} (ties in max); entry 3 has no
    valid row. ``holes`` clears the mask of every fifth row of entry 0 and 1
    while keeping its cell (rows of a run the pooling must skip: not a
    layout the loader makes, and not one the JAX kernel masks the same way)."""
    rng = np.random.default_rng(seed)
    side = 32  # cells per side of a 1024-cell tile
    n = 1200
    npad = aligned_bucket_size(n, reso)
    pts = np.full((4, npad, 3), 0.5, np.float32)
    mask = np.zeros((4, npad), bool)
    cells = np.zeros((4, npad), np.int32)
    toff = np.zeros((4, reso * reso // 1024 + 1), np.int32)
    for i in range(4):
        p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        m = np.ones(n, bool)
        if i == 0:  # 24 cells x 37 points in tile 0 (x, y < side / reso)
            cx = rng.choice(side * side, 24, replace=False)
            ix, iy = cx % side, cx // side
            xy = (np.stack([ix, iy], -1).repeat(37, 0) + rng.uniform(0.1, 0.9, (888, 2))) / reso
            p[:888, :2] = xy
        if i == 1:
            p[:300, :2] = (np.array([40, 21]) + rng.uniform(0.1, 0.9, (300, 2))) / reso
        if i == 2:
            p[:, :2] = rng.uniform(0.30, 0.36, (n, 2))
        if i == 3:
            m[:] = False
        a = host_morton_bucket_aligned(p, m, reso)
        pts[i], mask[i], cells[i], toff[i] = a["points"], a["mask"], a["cells"], a["tile_offsets"]
    vals = rng.normal(size=(4, npad, f)).astype(np.float32)
    vals[2] = rng.integers(0, 3, (npad, f))
    if holes:
        for i in (0, 1):
            rows = np.flatnonzero(mask[i])[::5]
            mask[i, rows] = False
    return pts, mask, cells, toff, vals


def _run_points(rng, i: int, n: int, pads: bool = False):
    """Points and mask of entry i of :func:`tile_run_batch` and
    :func:`sorted_run_batch` at FINEST: entry 0 puts 24 cells x 37 points
    into finest tile 0, 300 into one cell of tile 9 and the rest into the
    first quarter; entry 1 spreads its points over the plane (``pads``:
    masks a tenth); entry 2 crowds them into a few cells; entry 3 has no
    valid point."""
    p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    m = np.ones(n, bool)
    if i == 0:
        cx = rng.choice(256, 24, replace=False)  # cells of 16 x 16 tile 0
        xy = np.stack([cx % 16, cx // 16], -1).repeat(37, 0) + rng.uniform(0.1, 0.9, (888, 2))
        p[:888, :2] = xy / FINEST
        p[888:1188, :2] = (np.array([40, 21]) + rng.uniform(0.1, 0.9, (300, 2))) / FINEST
        p[1188:, :2] = rng.uniform(0.0, 0.25, (n - 1188, 2))
    if i == 1 and pads:
        m = rng.random(n) > 0.1
    if i == 2:
        p[:, :2] = rng.uniform(0.30, 0.36, (n, 2))
    if i == 3:
        m[:] = False
    return p, m


def tile_run_batch(seed: int, f: int = 8, foreign: bool = False, past: bool = False):
    """Four patches on the fused layout (finest 256^2, 256-cell tiles),
    trimmed as the loader trims them: entry 0 puts 24 cells x 37 points into
    finest tile 0 (runs across every span edge there, and one run of 888+
    rows at 16^2) and 300 points into one cell of tile 9; entry 1 spreads its
    points over the plane; entry 2 crowds them into a few cells; entry 3 has
    no valid row. ``foreign`` writes a cell of the last quarter of the plane
    into the first pad row of each padded tile among the first 64 (the first
    quarter): rows of another tile at every level down to 32^2. ``past``
    writes a cell of tile 0 into the last row of each entry whose tiles end
    before it: a row past the last tile."""
    rng = np.random.default_rng(seed)
    n = 1500
    npad = aligned_bucket_size(n, FINEST, tile_cells=256)
    out = {k: [] for k in ("points", "mask", "cells", "tile_offsets")}
    for i in range(4):
        p, m = _run_points(rng, i, n)
        a = host_morton_bucket_aligned(p, m, FINEST, tile_cells=256)
        assert a["cells"].shape == (npad,)
        for k in out:
            out[k].append(a[k])
    pts, mask, cells, toff = trim_aligned_batch(*(np.stack(out[k]) for k in out))
    cells = cells.copy()
    if foreign:
        for i in range(3):
            for tt in range(64):
                lo, hi = toff[i, tt], toff[i, tt + 1]
                pads = np.flatnonzero(cells[i, lo:hi] == PAD_CELL_SENTINEL)
                if pads.size:
                    cells[i, lo + pads[0]] = rng.integers(3 * 65536 // 4, 65536)
    if past:
        for i in range(4):
            if toff[i, -1] < cells.shape[1]:
                cells[i, -1] = rng.integers(0, 256)
    vals = rng.normal(size=mask.shape + (f,)).astype(np.float32)
    vals[~mask] = 1e9  # junk on pad rows must not leak
    return pts, mask, cells, toff, vals


def sorted_run_batch(seed: int, f: int = 8, moved: bool = False):
    """Four patches on the plain sorted layout at the finest resolution
    (``host_morton_bucket``: rows Morton-sorted, pads at the end with id
    FINEST**2, per-cell offsets), the points of :func:`tile_run_batch`: entry
    0 puts 24 cells x 37 points into finest tile 0 (runs across every span
    edge) and 300 into one cell of tile 9; entry 1 spreads its points over
    the plane and masks a tenth (pads); entry 2 crowds them into a few cells;
    entry 3 has no valid row. ``moved`` writes a cell of the last quarter of
    the plane into the first row of each occupied tile among the first 64
    (the first quarter): rows out of their tile at every level down to 32^2;
    and a cell of tile 0 into the last row of each entry that has pads: a row
    past the last tile."""
    rng = np.random.default_rng(seed)
    n = 1500
    ncell = FINEST * FINEST
    vals = rng.normal(size=(4, n, f)).astype(np.float32)
    cells = np.empty((4, n), np.int32)
    offs = np.empty((4, ncell + 1), np.int32)
    for i in range(4):
        p, m = _run_points(rng, i, n, pads=True)
        _, cells[i], offs[i] = host_morton_bucket(p, m, FINEST)
        vals[i, offs[i, -1]:] = 1e9  # junk on pad rows must not leak
    if moved:
        for i in range(4):
            for tt in range(64):
                lo, hi = offs[i, 256 * tt], offs[i, 256 * (tt + 1)]
                if hi > lo:
                    cells[i, lo] = rng.integers(3 * ncell // 4, ncell)
            if offs[i, -1] < n:
                cells[i, -1] = rng.integers(0, 256)
    return vals, cells, offs


def level_inputs(reso, level_reso, f, fl, seed, b=2, n=700, empty_last=False):
    """Aligned points plus a plane, c_last and fc_comm/fc_c weights."""
    rng = np.random.default_rng(seed)
    npad = aligned_bucket_size(n, reso)
    pts = np.full((b, npad, 3), 0.5, np.float32)
    mask = np.zeros((b, npad), bool)
    cells = np.zeros((b, npad), np.int32)
    toff = np.zeros((b, reso * reso // 1024 + 1), np.int32)
    for i in range(b):
        p = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        p[:2, :2] = [[0.0, 0.0], [1.0, 1.0]]  # border clamp, +1 neighbour weight 0
        m = rng.random(n) > 0.1
        if empty_last and i == b - 1:
            m[:] = False
        a = host_morton_bucket_aligned(p, m, reso)
        pts[i], mask[i], cells[i], toff[i] = a["points"], a["mask"], a["cells"], a["tile_offsets"]
    plane = rng.normal(0, 1, (b, level_reso, level_reso, f)).astype(np.float32)
    c_last = np.where(mask[..., None], rng.normal(0, 1, (b, npad, fl)), 0).astype(np.float32)
    # std 0.2, or 1/sqrt(fan_in) where that is smaller: wide levels keep
    # activations O(1), as trained weights do
    s = lambda fan, *sh: rng.normal(0, min(0.2, fan ** -0.5), sh).astype(np.float32)  # noqa: E731
    weights = (s(f, f, 2 * f), s(1, 2 * f), s(2 * f, 2 * f, f), s(1, f), s(fl, fl, f), s(1, f))
    return pts, mask, cells, toff, plane, c_last, weights


def level_cotangents(inp, seed):
    """Output cotangents (g_plane, g_c) for :func:`level_inputs`."""
    rng = np.random.default_rng(seed)
    _, mask, _, _, plane, _, _ = inp
    g_p = rng.normal(0, 1, plane.shape).astype(np.float32)
    g_c = rng.normal(0, 1, mask.shape + (plane.shape[-1],)).astype(np.float32)
    return g_p, g_c


def tile_batch(seed: int, b: int = 2, n: int = 900, reso: int = RESO, f: int = 32,
               edge: str = "none"):
    """b patches on the aligned layout with 256-cell tiles (the ``fused``
    kernels' contract: tests/test_pallas_aligned.py) and junk values on the
    pad rows. ``edge`` names the cases to build: 'empty' masks every point
    of the last entry, 'border' puts points on the plane's edges and
    corners, 'one_cell' puts every point of entry 0 into one cell."""
    rng = np.random.default_rng(seed)
    npad = aligned_bucket_size(n, reso, tile_cells=256)
    pts = np.zeros((b, npad, 3), np.float32)
    mask = np.zeros((b, npad), bool)
    cells = np.zeros((b, npad), np.int32)
    toff = np.zeros((b, reso * reso // 256 + 1), np.int32)
    for i in range(b):
        p = rng.uniform(0.001, 0.999, (n, 3)).astype(np.float32)
        m = rng.random(n) > 0.1
        if "border" in edge:
            p[: n // 4, 0] = rng.uniform(0.0, 0.01, n // 4)
            p[n // 4: n // 2, 1] = rng.uniform(0.99, 1.0, n // 4)
            p[:4, :2] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]]
        if "one_cell" in edge and i == 0:
            p[:, :2] = 0.51
        if "empty" in edge and i == b - 1:
            m[:] = False
        a = host_morton_bucket_aligned(p, m, reso, tile_cells=256)
        pts[i], mask[i], cells[i], toff[i] = a["points"], a["mask"], a["cells"], a["tile_offsets"]
    vals = rng.normal(size=(b, npad, f)).astype(np.float32)
    vals[~mask] = 1e9  # junk on pad rows must not leak
    return pts, mask, cells, toff, vals


def sorted_batch(seed: int, b: int = 2, n: int = 1024, n_valid: int = 900,
                 reso: int = 32, f: int = 8, one_cell: bool = False):
    """b patches on the plain sorted layout (tests/test_pallas_kernel.py):
    values, cells at ``reso`` (pads reso**2) and per-cell offsets."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.001, 0.999, (b, n, 3)).astype(np.float32)
    if one_cell:
        pts[:] = 0.51
    mask = np.zeros((b, n), bool)
    mask[:, :n_valid] = True
    vals = rng.normal(size=(b, n, f)).astype(np.float32)
    cells = np.empty((b, n), np.int32)
    offs = np.empty((b, reso * reso + 1), np.int32)
    for i in range(b):
        order, cells[i], offs[i] = host_morton_bucket(pts[i], mask[i], reso)
        vals[i] = vals[i][order]
    return vals, cells, offs


def t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def run_level(inp, reso, level_reso, fn=lk.fused_level, device="cpu"):
    pts, mask, cells, _, plane, c_last, weights = inp
    return fn(t(plane, device), t(c_last, device), tuple(t(w, device) for w in weights),
              t(pts[..., :2], device), t(cells, device), t(mask, device),
              level_reso, reso)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestPool2Kernels:
    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_pool2_matches_plain(self, cuda, kind):
        _, mask, cells, _, vals = aligned_batch(0)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        before = dict(runtime.LAUNCHES)
        got = pk.pool2(v, c, m, RESO, kind)
        want = pk.pool2_plain(v, c, m, RESO, kind)
        torch.cuda.synchronize()
        if kind == "max":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **TOL)
        # one launch of the run kernel, no gather
        assert runtime.LAUNCHES["pool2"] == before["pool2"] + 1
        assert runtime.LAUNCHES["pool_gather"] == before["pool_gather"]

    def test_scatter_plane2_matches_plain(self, cuda):
        _, mask, cells, _, vals = aligned_batch(1)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        n0 = runtime.LAUNCHES["scatter_plane2"]
        plane, counts = pk.scatter_plane2(v, c, m, RESO)
        want_plane, want_counts = pk.scatter_plane2_plain(v, c, m, RESO)
        torch.cuda.synchronize()
        torch.testing.assert_close(plane, want_plane, **TOL)
        assert torch.equal(counts, want_counts)
        assert runtime.LAUNCHES["scatter_plane2"] == n0 + 1

    def test_sum_kind_matches_plain(self, cuda):
        _, mask, cells, _, vals = tied_batch(0)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        got = pk.pool2_fwd(v, c, m, RESO, "sum")
        want = pk.pool2_plain(v, c, m, RESO, "sum")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_pool2_backward_matches_plain(self, cuda, kind):
        _, mask, cells, _, vals = tied_batch(1)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        g = torch.randn(v.shape, generator=torch.Generator().manual_seed(0)).to(cuda)
        out = pk.pool2(v, c, m, RESO, kind)
        before = dict(runtime.LAUNCHES)
        got = pk.pool2_bwd(g, v, out, c, m, RESO, kind)
        want = pk.pool2_bwd_plain(g, v, out, c, m, RESO, kind)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert runtime.LAUNCHES["pool2_bwd"] == before["pool2_bwd"] + 1
        assert runtime.LAUNCHES["pool2"] == before["pool2"]
        assert runtime.LAUNCHES["pool_gather"] == before["pool_gather"]

    @pytest.mark.parametrize("holes", [False, True])
    @pytest.mark.parametrize("f", [8, 40])
    @pytest.mark.parametrize("kind", ["max", "mean", "sum"])
    def test_run_layouts_match_plain(self, cuda, kind, f, holes):
        """Runs of 300 rows, runs across every span edge, ties, an empty
        entry, rows cleared inside a run; F = 40 takes two feature chunks.
        Sums are held to the plain version in float64: in float32 on the
        card it adds with atomics in any order, which over a 300-row run
        moves a sum by up to ~1e-5, as far as the kernel's fixed row order
        does (in a numpy emulation of that order, up to 0.34 of TOL from
        float64 on these layouts, 0.86 on the backward's), so the two
        float32 sums can differ by more than TOL."""
        _, mask, cells, _, vals = run_batch(2, f=f, holes=holes)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        got = pk.pool2_fwd(v, c, m, RESO, kind)
        torch.cuda.synchronize()
        if kind == "max":
            assert torch.equal(got, pk.pool2_plain(v, c, m, RESO, kind))
        else:
            want = pk.pool2_plain(v.double(), c, m, RESO, kind)
            torch.testing.assert_close(got.double(), want, **TOL)

    @pytest.mark.parametrize("holes", [False, True])
    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_run_layouts_backward_match_plain(self, cuda, kind, holes):
        """As the forward, held to the plain version in float64."""
        _, mask, cells, _, vals = run_batch(4, f=40, holes=holes)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        g = torch.randn(v.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
        out = pk.pool2(v, c, m, RESO, kind)
        got = pk.pool2_bwd(g, v, out, c, m, RESO, kind)
        want = pk.pool2_bwd_plain(g.double(), v.double(), out.double(), c, m, RESO, kind)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.double(), want, **TOL)

    def test_bit_equal_run_to_run(self, cuda):
        """The run kernel sums in row order: forward and backward repeat
        bit for bit."""
        _, mask, cells, _, vals = run_batch(5, f=32)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        g = torch.randn(v.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
        for kind in ("max", "mean"):
            out = pk.pool2(v, c, m, RESO, kind)
            assert torch.equal(out, pk.pool2(v, c, m, RESO, kind))
            dv = pk.pool2_bwd(g, v, out, c, m, RESO, kind)
            assert torch.equal(dv, pk.pool2_bwd(g, v, out, c, m, RESO, kind))

    def test_allocates_no_cell_buffer(self, cuda):
        """At reso 256 a (B, reso^2, F) cell buffer would be 7x the output:
        the forward allocates its output alone."""
        _, mask, cells, _, vals = aligned_batch(0, reso=256)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = pk.pool2_fwd(v, c, m, 256, "mean")
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before <= out.numel() * 4 + 512
        torch.testing.assert_close(out, pk.pool2_plain(v, c, m, 256, "mean"), **TOL)

    def test_scatter_plane2_backward_matches_plain(self, cuda):
        _, mask, cells, _, vals = aligned_batch(2)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        _, counts = pk.scatter_plane2(v, c, m, RESO)
        g = torch.randn((v.shape[0], RESO, RESO, v.shape[-1]),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
        before = dict(runtime.LAUNCHES)
        got = pk.scatter_plane2_bwd(g, c, m, counts)
        want = pk.scatter_plane2_bwd_plain(g, c, m, counts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert runtime.LAUNCHES["pool_gather"] == before["pool_gather"] + 1
        assert runtime.LAUNCHES["scatter_plane2_bwd"] == before["scatter_plane2_bwd"] + 1

    @pytest.mark.parametrize("order", ["sorted", "unsorted"])
    @pytest.mark.parametrize("f", [8, 40, 64, 128])
    @pytest.mark.parametrize("holes", [False, True])
    def test_scatter_plane2_backward_on_the_run_layouts(self, cuda, holes, f, order):
        """K2 alone on runs of 300 rows, runs across every span edge, masked
        rows inside runs, pads and an empty entry, and on the same rows in a
        random order (K2 takes any order); F = 40, 64 and 128 take two, two
        and four chunks of 32 features. Held to the plain version and
        bit-equal on a second launch."""
        _, mask, cells, _, vals = run_batch(6, f=f, holes=holes)
        if order == "unsorted":
            perm = np.stack([np.random.default_rng(i).permutation(mask.shape[1])
                             for i in range(mask.shape[0])])
            mask, cells = (np.take_along_axis(x, perm, 1) for x in (mask, cells))
            vals = np.take_along_axis(vals, perm[..., None], 1)
        v, c, m = t(vals, cuda), t(cells, cuda), t(mask, cuda)
        _, counts = pk.scatter_plane2_plain(v, c, m, RESO)
        g = torch.randn((v.shape[0], RESO, RESO, f),
                        generator=torch.Generator().manual_seed(f)).to(cuda)
        got = pk.scatter_plane2_bwd(g, c, m, counts)
        again = pk.scatter_plane2_bwd(g, c, m, counts)
        want = pk.scatter_plane2_bwd_plain(g, c, m, counts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)
        assert (got[~m] == 0).all()

    @pytest.mark.parametrize("f", [32, 6])
    def test_scatter_plane2_backward_writes_every_row(self, cuda, f):
        """At the flagship's shapes, into an output pre-filled with NaN: every
        row, pads included, is written (F = 6: one partial chunk)."""
        cells, mask, _ = _flagship(1024)
        v = _rows(mask, f, 2)
        _, counts = pk.scatter_plane2(v, cells, mask, 256)
        g = torch.randn((v.shape[0], 256, 256, f),
                        generator=torch.Generator().manual_seed(3)).to(cuda)
        out = torch.full_like(v, float("nan"))
        b, n, _ = v.shape
        err = runtime.library().t2h_pool_gather(
            g.data_ptr(), cells.data_ptr(), mask.data_ptr(), counts.data_ptr(), out.data_ptr(),
            b, n, f, 256, 0, runtime.stream_ptr(cuda))
        runtime.check(err, "pool_gather")
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, pk.scatter_plane2_bwd_plain(g, cells, mask, counts),
                                   **TOL)

    def test_wrong_dtype_raises(self, cuda):
        _, mask, cells, _, vals = aligned_batch(0)
        with pytest.raises(TypeError):
            pk.pool2(t(vals, cuda).double(), t(cells, cuda), t(mask, cuda), RESO, "max")


def _flagship(tile_cells: int):
    """chip_smoke's flagship batch on the card: (cells, mask, tile offsets)
    of B = 8 16384-point buckets on the aligned layout."""
    import chip_smoke as cs

    _, _, _, amask, acell, toff = cs.flagship_batch(0, tile_cells=tile_cells)
    return (torch.from_numpy(x).cuda() for x in (acell, amask, toff))


def _rows(mask, f, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*mask.shape, f, generator=g).cuda() * mask[..., None]).contiguous()


def _scatter_runs_into(values, cells, mask, toff, reso, shift, plane, counts, flags,
                       step=1, morton=False):
    """``t2h_scatter_runs`` straight into given outputs (the wrappers allocate
    their own); ``step``: the tile-offset step (K12 1, K11 and K13 256);
    ``morton``: K13's Morton-order store."""
    b, n, f = values.shape
    err = runtime.library().t2h_scatter_runs(
        values.data_ptr(), cells.data_ptr(), 0 if mask is None else mask.data_ptr(),
        0 if toff is None else toff.data_ptr(), plane.data_ptr(),
        0 if counts is None else counts.data_ptr(), flags.data_ptr(), b, n, f, reso, shift,
        0 if toff is None else toff.shape[1], step, int(morton),
        runtime.stream_ptr(values.device))
    runtime.check(err, "scatter_runs")


def _sorted_flagship(reso: int):
    """chip_smoke's flagship batch on the plain sorted layout at ``reso`` as
    ``check_tile_kernels`` gives it to K11: (mask, ids >> shift, per-cell
    offsets strided by 4**level) of B = 8 16384-point buckets."""
    import chip_smoke as cs

    pts, mask, *_ = cs.flagship_batch(5, tile_cells=256)
    _, smask, scells, soffs = cs.sorted_layout(pts, mask)
    shift = 2 * (9 - reso.bit_length())
    return (torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in (smask, scells >> shift, soffs[:, :: 4 ** (shift // 2)]))


@pytest.mark.cuda
class TestScatterRuns:
    """K3 and K12 on the run scatter (``csrc/pool2.cu`` ``scatter_runs``) at
    the flagship's shapes: held to their plain versions, bit-equal on a
    second launch, every cell written (NaN-filled outputs come out finite),
    and the model paths' launch counts those of ``chip_smoke.py``."""

    def test_scatter_plane2_at_the_flagship(self, cuda):
        cells, mask, _ = _flagship(1024)
        v = _rows(mask, 32, 0)
        before = dict(runtime.LAUNCHES)
        plane, counts = pk.scatter_plane2(v, cells, mask, 256)
        again = pk.scatter_plane2(v, cells, mask, 256)
        want_plane, want_counts = pk.scatter_plane2_plain(v, cells, mask, 256)
        torch.cuda.synchronize()
        _launched("scatter_plane2", before, 2)
        torch.testing.assert_close(plane, want_plane, **TOL)
        assert torch.equal(counts, want_counts)
        assert torch.equal(plane, again[0]) and torch.equal(counts, again[1])

    def test_scatter_plane2_backward_at_the_flagship(self, cuda):
        """K2 alone at the flagship's shapes: held to the plain version and
        bit-equal on a second launch."""
        cells, mask, _ = _flagship(1024)
        v = _rows(mask, 32, 4)
        _, counts = pk.scatter_plane2(v, cells, mask, 256)
        g = torch.randn((v.shape[0], 256, 256, 32),
                        generator=torch.Generator().manual_seed(4)).to(cuda)
        before = dict(runtime.LAUNCHES)
        got = pk.scatter_plane2_bwd(g, cells, mask, counts)
        again = pk.scatter_plane2_bwd(g, cells, mask, counts)
        want = pk.scatter_plane2_bwd_plain(g, cells, mask, counts)
        torch.cuda.synchronize()
        _launched("pool_gather", before, 2)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)

    @pytest.mark.parametrize("reso,f", [(256, 32), (256, 64), (128, 128), (64, 256),
                                        (32, 512), (16, 1024)])
    def test_aligned_scatter_at_the_flagship(self, cuda, reso, f):
        cells, mask, toff = _flagship(256)
        v = _rows(mask, f, reso)
        lvl = toff[:, :: 4 ** (9 - reso.bit_length())].contiguous()
        before = dict(runtime.LAUNCHES)
        got = sk.aligned_scatter_mean_plane(v, cells, lvl, reso, 256)
        again = sk.aligned_scatter_mean_plane(v, cells, lvl, reso, 256)
        want = sk.aligned_scatter_mean_plane_plain(v, cells, lvl, reso, 256)
        torch.cuda.synchronize()
        _launched("aligned_scatter_mean_plane", before, 2)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)

    @pytest.mark.parametrize("f", [32, 40, 6])
    def test_every_cell_is_written(self, cuda, f):
        """Into a plane and counts pre-filled with NaN and -1, flags with 1:
        the clear, the run pass and the zero pass leave nothing unwritten
        (F = 40 and 6: a second feature chunk, the scalar zero pass)."""
        cells, mask, toff = _flagship(256)
        v = _rows(mask, f, 1)
        b = v.shape[0]
        for reso, shift, m, tt in ((256, 0, mask, None), (32, 6, None, toff[:, ::64])):
            tt = None if tt is None else tt.contiguous()
            plane = torch.full((b, reso, reso, f), float("nan"), device=cuda)
            counts = torch.full((b, reso, reso), -1, device=cuda, dtype=torch.int32)
            flags = torch.ones((b, reso, reso), device=cuda, dtype=torch.uint8)
            _scatter_runs_into(v, cells, m, tt, reso, shift, plane,
                               counts if m is not None else None, flags)
            torch.cuda.synchronize()
            assert torch.isfinite(plane).all()
            if m is not None:
                want = pk.scatter_plane2_plain(v, cells, m, reso)
                assert torch.equal(counts, want[1])
            else:
                want = (sk.aligned_scatter_mean_plane_plain(v, cells, tt, reso, 256),)
            torch.testing.assert_close(plane, want[0], **TOL)

    def test_model_paths_launch_as_the_smoke_counts(self, cuda):
        """One fused2 training mini-step (remat), one 'fused' and one
        'pallas' forward launch what ``chip_smoke.TRAIN_LAUNCHES`` and
        ``SORTED_LAUNCHES`` say, K3, K10, K11 and K12 among them."""
        import chip_smoke as cs
        from tomosar2height_tpu_torch.config import flagship_config, sorted_config
        from tomosar2height_tpu_torch.models import build_model, init_weights
        from tomosar2height_tpu_torch.train import Trainer

        cfg = flagship_config()
        model = init_weights(build_model(cfg, "cuda"), torch.Generator().manual_seed(0))
        _, _, apts, amask, _, toff = cs.flagship_batch(1, b=2)
        side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
        batch = {"points": apts, "point_mask": amask, "cell_offsets": toff,
                 "dsm": np.zeros((2, side, side), np.float32),
                 "patch_valid": np.ones(2, bool)}
        runtime.reset_launches()
        Trainer(model, cfg["training"]).train_step(batch, 1e-4)
        torch.cuda.synchronize()
        assert {k: v for k, v in runtime.LAUNCHES.items() if v} == cs.TRAIN_LAUNCHES

        fcfg = sorted_config("fused")
        fused_model = build_model(fcfg, "cuda")
        fused_model.load_state_dict(model.state_dict())
        _, _, apts, amask, _, toff = cs.flagship_batch(2, b=2, tile_cells=256)
        runtime.reset_launches()
        with torch.inference_mode():
            h = fused_model.eval()(*(torch.from_numpy(x).cuda() for x in (apts, amask)),
                                   None, None, torch.from_numpy(toff).cuda(),
                                   footprint=False)[0]
        torch.cuda.synchronize()
        assert torch.isfinite(h).all()
        assert ({k: v for k, v in runtime.LAUNCHES.items() if v}
                == cs.SORTED_LAUNCHES["fused"])

        pallas_model = build_model(sorted_config("pallas"), "cuda")
        pallas_model.load_state_dict(model.state_dict())
        pts, mask, *_ = cs.flagship_batch(2, b=2, tile_cells=256)
        spts, smask, scells, soffs = (torch.from_numpy(x).cuda()
                                      for x in cs.sorted_layout(pts, mask))
        runtime.reset_launches()
        with torch.inference_mode():
            h = pallas_model.eval()(spts, smask, None, scells, soffs, footprint=False)[0]
        torch.cuda.synchronize()
        assert torch.isfinite(h).all()
        assert ({k: v for k, v in runtime.LAUNCHES.items() if v}
                == cs.SORTED_LAUNCHES["pallas"])


@pytest.mark.cuda
class TestTileRuns:
    """K11 (``scatter_mean_plane``, the plain sorted layout) and K13
    (``scatter_mean``, the same into the Morton-ordered cell vector) on the
    run scatter with the tile-offset step 256, and K10 (``tile_pool``) on
    ``pool_runs`` under the tile rule: held to their plain versions at the
    flagship's shapes and on the layouts of ``test_torch_scatter_runs.py``
    and ``test_torch_pool2_runs.py``, bit-equal on a second launch, every
    cell or row written (NaN-filled outputs come out finite)."""

    @pytest.mark.parametrize("reso,f", [(256, 32), (256, 64), (128, 128), (64, 256),
                                        (32, 512)])
    def test_scatter_mean_plane_at_the_flagship(self, cuda, reso, f):
        mask, cells, offs = _sorted_flagship(reso)
        v = _rows(mask, f, reso)
        before = dict(runtime.LAUNCHES)
        got = sk.scatter_mean_plane(v, cells, offs, reso)
        again = sk.scatter_mean_plane(v, cells, offs, reso)
        want = sk.scatter_mean_plane_plain(v, cells, offs, reso)
        torch.cuda.synchronize()
        _launched("scatter_mean_plane", before, 2)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)

    @pytest.mark.parametrize("reso,moved", [(256, False), (64, False), (16, False),
                                            (256, True), (32, True)])
    def test_scatter_mean_plane_on_the_run_layouts(self, cuda, reso, moved):
        """Runs across span edges, a 300-row cell, pads, an empty entry; rows
        out of their tile and a row past the last tile (``moved``)."""
        vals, cells, offs = sorted_run_batch(13, f=40, moved=moved)
        shift = 2 * (FINEST.bit_length() - reso.bit_length())
        v, c = t(vals, cuda), t(cells >> shift, cuda)
        o = t(offs[:, :: 4 ** (shift // 2)], cuda)
        got = sk.scatter_mean_plane(v, c, o, reso)
        want = sk.scatter_mean_plane_plain(v, c, o, reso)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert (got[-1] == 0).all()

    @pytest.mark.parametrize("f", [32, 40, 6])
    def test_scatter_mean_plane_writes_every_cell(self, cuda, f):
        """Into a plane pre-filled with NaN and flags with 1, at 256^2 and 32^2
        (F = 40 and 6: a second feature chunk, the scalar zero pass)."""
        for reso in (256, 32):
            mask, cells, offs = _sorted_flagship(reso)
            v = _rows(mask, f, 1)
            b = v.shape[0]
            plane = torch.full((b, reso, reso, f), float("nan"), device=cuda)
            flags = torch.ones((b, reso, reso), device=cuda, dtype=torch.uint8)
            _scatter_runs_into(v, cells, None, offs, reso, 0, plane, None, flags, step=256)
            torch.cuda.synchronize()
            assert torch.isfinite(plane).all()
            torch.testing.assert_close(plane, sk.scatter_mean_plane_plain(v, cells, offs, reso),
                                       **TOL)

    @pytest.mark.parametrize("reso,f", [(256, 32), (256, 64), (128, 128), (64, 256),
                                        (32, 512)])
    def test_scatter_mean_at_the_flagship(self, cuda, reso, f):
        """K13 (the Morton-ordered cell vector) at every width of
        ``chip_smoke.TILE_SCATTER_SHAPES``."""
        mask, cells, offs = _sorted_flagship(reso)
        v = _rows(mask, f, reso + 1)
        before = dict(runtime.LAUNCHES)
        got = sk.scatter_mean(v, cells, offs, reso)
        again = sk.scatter_mean(v, cells, offs, reso)
        want = sk.scatter_mean_plain(v, cells, offs, reso)
        torch.cuda.synchronize()
        _launched("scatter_mean", before, 2)
        assert got.shape == (v.shape[0], reso * reso, f)
        torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)

    @pytest.mark.parametrize("reso,moved", [(256, False), (64, False), (16, False),
                                            (256, True), (32, True)])
    def test_scatter_mean_on_the_run_layouts(self, cuda, reso, moved):
        """K13 on K11's run layouts: runs across span edges, a 300-row cell,
        pads, an empty entry; rows out of their tile and a row past the last
        tile (``moved``)."""
        vals, cells, offs = sorted_run_batch(13, f=40, moved=moved)
        shift = 2 * (FINEST.bit_length() - reso.bit_length())
        v, c = t(vals, cuda), t(cells >> shift, cuda)
        o = t(offs[:, :: 4 ** (shift // 2)], cuda)
        got = sk.scatter_mean(v, c, o, reso)
        want = sk.scatter_mean_plain(v, c, o, reso)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert (got[-1] == 0).all()

    @pytest.mark.parametrize("f", [32, 6])
    def test_scatter_mean_writes_every_cell(self, cuda, f):
        """Into a cell vector pre-filled with NaN and flags with 1, at 256^2
        and 32^2 (F = 6: the scalar zero pass)."""
        for reso in (256, 32):
            mask, cells, offs = _sorted_flagship(reso)
            v = _rows(mask, f, 5)
            b = v.shape[0]
            vec = torch.full((b, reso * reso, f), float("nan"), device=cuda)
            flags = torch.ones((b, reso * reso), device=cuda, dtype=torch.uint8)
            _scatter_runs_into(v, cells, None, offs, reso, 0, vec, None, flags, step=256,
                               morton=True)
            torch.cuda.synchronize()
            assert torch.isfinite(vec).all()
            torch.testing.assert_close(vec, sk.scatter_mean_plain(v, cells, offs, reso), **TOL)

    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_tile_pool_at_the_flagship(self, cuda, kind):
        cells, mask, toff = _flagship(256)
        v = _rows(mask, 32, 3)
        before = dict(runtime.LAUNCHES)
        got = tpk.tile_pool(v, cells, toff, kind)
        again = tpk.tile_pool(v, cells, toff, kind)
        want = tpk.tile_pool_plain(v, cells, toff, kind)
        torch.cuda.synchronize()
        _launched("tile_pool", before, 2)
        if kind == "max":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **TOL)
        assert torch.equal(got, again)

    @pytest.mark.parametrize("kind", ["max", "mean"])
    @pytest.mark.parametrize("edges", [False, True])
    def test_tile_pool_on_the_run_layouts(self, cuda, kind, edges):
        """Pads at tile ends (junk values), runs across span edges, a 300-row
        cell, an empty entry; rows of another tile and rows past the last
        tile with in-range ids (``edges``): all but the valid rows 0."""
        _, mask, cells, toff, vals = tile_run_batch(11, f=40, foreign=edges, past=edges)
        v, c, tt = t(vals, cuda), t(cells, cuda), t(toff, cuda)
        got = tpk.tile_pool(v, c, tt, kind)
        want = tpk.tile_pool_plain(v, c, tt, kind)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert (got[t(~mask, cuda)] == 0).all()

    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_tile_pool_writes_every_row(self, cuda, kind):
        """Into an output pre-filled with NaN: every row, pads and rows past
        the last tile included, is written."""
        cells, mask, toff = _flagship(256)
        v = _rows(mask, 40, 4)
        b, n, f = v.shape
        out = torch.full_like(v, float("nan"))
        err = runtime.library().t2h_pool_runs(
            v.data_ptr(), cells.data_ptr(), 0, toff.data_ptr(), 0, 0, out.data_ptr(), b, n,
            f, (toff.shape[1] - 1) * 256, {"max": 0, "mean": 1}[kind],
            runtime.stream_ptr(cuda))
        runtime.check(err, "pool_runs")
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, tpk.tile_pool_plain(v, cells, toff, kind), **TOL)


@pytest.mark.cuda
class TestLevelKernel:
    @pytest.mark.parametrize("reso,level_reso,f,fl", [
        (64, 64, 8, 4), (64, 32, 16, 16), (32, 32, 8, 8), (256, 32, 512, 256),
        (256, 32, 512, 1024), (64, 32, 64, 600)])
    def test_matches_plain(self, cuda, reso, level_reso, f, fl):
        inp = level_inputs(reso, level_reso, f, fl, seed=7, empty_last=True)
        before = dict(runtime.LAUNCHES)
        got = run_level(inp, reso, level_reso, device=cuda)
        want = run_level(inp, reso, level_reso, fn=lk.fused_level_plain, device=cuda)
        torch.cuda.synchronize()
        _launched("fused_level", before)
        _launched("fused_level_scatter", before)
        torch.testing.assert_close(got[0], want[0], **TOL)
        torch.testing.assert_close(got[1], want[1], **TOL)
        assert torch.equal(got[2], want[2])
        assert (got[1][-1] == 0).all()  # the empty patch

    @pytest.mark.parametrize("level_reso,f,fl", [(256, 32, 32), (128, 128, 64),
                                                 (64, 256, 128), (32, 512, 256)])
    def test_plane_and_counts_are_bit_equal_run_to_run(self, cuda, level_reso, f, fl):
        """K4's plane is the run scatter of c_out: each cell written once
        from its run's row-order sum, so the plane, the counts and c_out are
        bit-equal on every launch."""
        inp = level_inputs(256, level_reso, f, fl, seed=23, b=2, n=4000)
        first = run_level(inp, 256, level_reso, device=cuda)
        for _ in range(3):
            again = run_level(inp, 256, level_reso, device=cuda)
            assert all(torch.equal(a, b) for a, b in zip(again, first))


def assert_level_grads_close(got, want):
    """K5's tolerance: see the module docstring."""
    torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=2e-4)
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, atol=3e-4 * float(b.abs().max()), rtol=3e-4)


@pytest.mark.cuda
class TestLevelBackwardKernel:
    @pytest.mark.parametrize("reso,level_reso,f,fl", [
        (64, 64, 8, 4), (64, 32, 16, 16), (32, 32, 8, 8), (256, 32, 512, 256),
        (256, 64, 256, 512)])
    def test_matches_plain(self, cuda, reso, level_reso, f, fl):
        inp = level_inputs(reso, level_reso, f, fl, seed=9, empty_last=True)
        pts, mask, cells, _, plane, c_last, weights = inp
        _, _, counts = run_level(inp, reso, level_reso, device=cuda)
        g_p, g_c = (t(x, cuda) for x in level_cotangents(inp, seed=3))
        args = (t(plane, cuda), t(c_last, cuda), tuple(t(w, cuda) for w in weights),
                t(pts[..., :2], cuda), t(cells, cuda), t(mask, cuda), counts, g_p, g_c,
                level_reso, reso)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level_bwd(*args)
        want = lk.fused_level_bwd_plain(*args)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_level_bwd"] == before["fused_level_bwd"] + 1
        assert runtime.LAUNCHES["level_bwd_reduce"] == before["level_bwd_reduce"] + 3
        assert_level_grads_close(got, want)
        assert (got[0][-1] == 0).all() and (got[1][-1] == 0).all()  # the empty patch

    @pytest.mark.parametrize("fl", [1024])
    def test_wide_c_last_at_flagship_size(self, cuda, fl):
        """K4 and K5 at the first up level of a depth-6 U-Net (R=32, F=512,
        Fl=1024) on B=8 patches of the flagship's 16384 points. K5 is held on
        the rows whose fc_comm pre-activations lie >= 2e-5 from ReLU's kink
        (chip_smoke.KINK): there the kernel and cuBLAS may open other gates."""
        inp = level_inputs(256, 32, 512, fl, seed=5, b=8, n=16384)
        pts, mask, cells, _, plane, c_last, weights = inp
        n0 = dict(runtime.LAUNCHES)
        got = run_level(inp, 256, 32, device=cuda)
        want = run_level(inp, 256, 32, fn=lk.fused_level_plain, device=cuda)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_level"] == n0["fused_level"] + 1
        torch.testing.assert_close(got[0], want[0], **TOL)
        torch.testing.assert_close(got[1], want[1], **TOL)
        w = tuple(t(x, cuda) for x in weights)
        xy = t(pts[..., :2], cuda)
        pre = grid_sample_2d(t(plane, cuda), xy) @ w[0] + w[1]
        m5 = t(mask, cuda) & ~(pre.abs() < 2e-5).any(-1)
        args = (t(plane, cuda), t(c_last, cuda), w, xy, t(cells, cuda), m5)
        counts = lk.fused_level(*args, 32, 256)[2]
        g_p, g_c = (t(x, cuda) for x in level_cotangents(inp, seed=6))
        bargs = args + (counts, g_p, g_c, 32, 256)
        got_b = lk.fused_level_bwd(*bargs)
        want_b = lk.fused_level_bwd_plain(*bargs)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_level_bwd"] == n0["fused_level_bwd"] + 1
        assert got_b[1].shape == (8, mask.shape[1], fl)
        assert_level_grads_close(got_b, want_b)

    def test_autograd_runs_the_kernels(self, cuda):
        inp = level_inputs(64, 32, 16, 16, seed=4)
        pts, mask, cells, _, plane, c_last, weights = inp
        p = t(plane, cuda).requires_grad_()
        w = tuple(t(x, cuda).requires_grad_() for x in weights)
        n0 = runtime.LAUNCHES["fused_level_bwd"]
        po, co, _ = lk.fused_level(p, t(c_last, cuda), w, t(pts[..., :2], cuda),
                                   t(cells, cuda), t(mask, cuda), 32, 64)
        (po.sum() + co.sum()).backward()
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_level_bwd"] == n0 + 1
        assert torch.isfinite(p.grad).all() and all(torch.isfinite(x.grad).all() for x in w)


@pytest.mark.cuda
class TestTensorCoreLevelKernels:
    """K4 and K5's weight-gradient reduction run on the tensor cores at fp32
    accuracy (3xTF32): held to their plain versions at ragged shapes, with
    the tolerances above unchanged."""

    @pytest.mark.parametrize("m,ka,nb,bias", [
        (50001, 32, 32, True), (50001, 512, 64, True), (20011, 1024, 1024, False),
        (4099, 512, 1024, True), (163843, 32, 1024, True), (777, 33, 65, True),
        (3001, 1024, 32, False)])
    def test_reduce_matches_plain(self, cuda, m, ka, nb, bias):
        """M not a multiple of the 32-row step or of the split; Ka 32, 512
        with the bias column, 1024; Nb 32, 64, 1024; odd widths take the
        4-byte copies."""
        rng = np.random.default_rng(m + ka + nb)
        a = t(rng.normal(size=(m, ka)).astype(np.float32), cuda)
        b = t(rng.normal(size=(m, nb)).astype(np.float32), cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.level_bwd_reduce(a, b, bias)
        want = lk.level_bwd_reduce_plain(a, b, bias)
        torch.cuda.synchronize()
        _launched("level_bwd_reduce", before)
        assert got[0].shape == (ka, nb) and (got[1] is None) == (not bias)
        for x, y in zip(got, want):
            if y is not None:
                torch.testing.assert_close(x, y, atol=3e-4 * float(y.abs().max()), rtol=3e-4)

    def test_reduce_is_bit_equal_run_to_run(self, cuda):
        rng = np.random.default_rng(11)
        a = t(rng.normal(size=(100003, 512)).astype(np.float32), cuda)
        b = t(rng.normal(size=(100003, 1024)).astype(np.float32), cuda)
        first = lk.level_bwd_reduce(a, b, True)
        second = lk.level_bwd_reduce(a, b, True)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])

    @pytest.mark.parametrize("f,fl", [(32, 32), (64, 32), (256, 128), (512, 256)])
    def test_level_c_out_is_bit_equal_run_to_run(self, cuda, f, fl):
        """c_out has no atomics: runs that differ in a bit read shared memory
        that no thread wrote."""
        inp = level_inputs(256, 64, f, fl, seed=19, b=2, n=4000)
        first = run_level(inp, 256, 64, device=cuda)[1]
        for _ in range(5):
            assert torch.equal(run_level(inp, 256, 64, device=cuda)[1], first)

    @pytest.mark.parametrize("level_reso,f,fl", [(256, 32, 32), (32, 512, 1024),
                                                 (32, 512, 256), (64, 256, 512)])
    def test_level_ragged_rows_and_padding_blocks(self, cuda, level_reso, f, fl):
        """N not a multiple of the block's 64 rows, and a patch whose every
        row is padding (all its blocks take the shortcut)."""
        inp = level_inputs(256, level_reso, f, fl, seed=17, b=3, n=3000, empty_last=True)
        cut = inp[1].shape[1] - 37
        inp = tuple(x[:, :cut] if i in (0, 1, 2, 5) else x for i, x in enumerate(inp))
        before = dict(runtime.LAUNCHES)
        got = run_level(inp, 256, level_reso, device=cuda)
        want = run_level(inp, 256, level_reso, fn=lk.fused_level_plain, device=cuda)
        torch.cuda.synchronize()
        _launched("fused_level", before)
        assert got[1].shape == (3, cut, f)
        torch.testing.assert_close(got[0], want[0], **TOL)
        torch.testing.assert_close(got[1], want[1], **TOL)
        assert torch.equal(got[2], want[2])
        assert (got[1][-1] == 0).all() and (got[1][t(~inp[1], cuda)] == 0).all()


def kink_free(inp, level_reso, reso, device, kink=2e-5):
    """K5's arguments for :func:`level_inputs` on the rows whose fc_comm
    pre-activations lie >= ``kink`` from ReLU's (chip_smoke.KINK): there
    the kernel and cuBLAS may open other gates. Returns (args, mask)."""
    pts, mask, cells, _, plane, c_last, weights = inp
    w = tuple(t(x, device) for x in weights)
    xy = t(pts[..., :2], device)
    pre = grid_sample_2d(t(plane, device), xy) @ w[0] + w[1]
    m5 = t(mask, device) & ~(pre.abs() < kink).any(-1)
    args = (t(plane, device), t(c_last, device), w, xy, t(cells, device), m5)
    counts = lk.fused_level(*args, level_reso, reso)[2]
    g_p, g_c = (t(x, device) for x in level_cotangents(inp, seed=8))
    return args + (counts, g_p, g_c, level_reso, reso), m5


@pytest.mark.cuda
class TestTensorCoreRowPass:
    """K5's row pass on the tensor cores (3xTF32, 64 rows a block, the hidden
    layer in 64-column chunks): d_plane and d_c_last at K5's tolerance, its
    scratch rows (s, h, d_o at 1e-5; d_h at K5's) on the rows it computes,
    and the whole K5 at its tolerance."""

    @pytest.mark.parametrize("level_reso,f,fl", [
        (256, 32, 32), (128, 128, 64), (64, 256, 512), (32, 512, 256), (32, 512, 1024),
        (64, 8, 4), (32, 9, 6)])
    def test_ragged_rows_and_padding_blocks(self, cuda, level_reso, f, fl):
        """N not a multiple of 64, a patch of padding only (its blocks take
        the shortcut); F = 512 runs 16 hidden chunks, Fl = 1024 two column
        chunks of d_c_last; odd widths take the 4-byte copies. The d_plane
        pass on the kernel's d_s against the plain adjoint of the same d_s."""
        inp = level_inputs(256, level_reso, f, fl, seed=31, b=3, n=3000, empty_last=True)
        cut = inp[1].shape[1] - 37
        inp = tuple(x[:, :cut] if i in (0, 1, 2, 5) else x for i, x in enumerate(inp))
        args, m5 = kink_free(inp, level_reso, 256, cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level_bwd_rows(*args)
        want = lk.fused_level_bwd_rows_plain(*args)
        torch.cuda.synchronize()
        _launched("fused_level_bwd", before)
        assert got[0].shape == (3, cut, fl) and got[2].shape == (3 * cut, 2 * f)
        bwd = dict(atol=2e-5, rtol=2e-4)
        torch.testing.assert_close(got[0], want[0], **bwd)
        v = m5.reshape(-1)
        for a, b, tol in zip(got[1:], want[1:], (TOL, TOL, TOL, bwd, bwd)):
            torch.testing.assert_close(a[v], b[v], **tol)
        assert (got[0][-1] == 0).all()  # the empty patch
        assert all((x.reshape(3, cut, -1)[-1] == 0).all() for x in got[1:])
        xy, cells = args[3], args[4]
        d_s = got[-1].view(3, cut, f)
        d_plane = lk.level_d_plane(d_s, xy, cells, m5, level_reso, 256)
        torch.testing.assert_close(
            d_plane, lk.level_d_plane_plain(d_s, xy, cells, m5, level_reso, 256), **bwd)
        assert (d_plane[-1] == 0).all()
        assert_level_grads_close(lk.fused_level_bwd(*args), lk.fused_level_bwd_plain(*args))

    @pytest.mark.parametrize("level_reso,f,fl", [(256, 32, 32), (64, 256, 128),
                                                 (32, 512, 256)])
    def test_rows_are_bit_equal_run_to_run(self, cuda, level_reso, f, fl):
        """The row pass, the d_plane pass and the whole K5 come without
        atomics: bit-equal on every launch."""
        inp = level_inputs(256, level_reso, f, fl, seed=37, b=2, n=4000)
        args, _ = kink_free(inp, level_reso, 256, cuda)
        first = lk.fused_level_bwd_rows(*args)
        whole = lk.fused_level_bwd(*args)
        for _ in range(3):
            again = lk.fused_level_bwd_rows(*args)
            assert all(torch.equal(a, b) for a, b in zip(again, first))
            w2 = lk.fused_level_bwd(*args)
            assert torch.equal(w2[0], whole[0]) and torch.equal(w2[1], whole[1])
            assert all(torch.equal(a, b) for a, b in zip(w2[2], whole[2]))


@pytest.mark.cuda
class TestDPlanePass:
    """K5's d_plane pass (``level_d_plane``: a warp a pixel walks its
    rectangle of finest cells in a fixed order) against the plain bilinear
    transpose at K5's tolerance, on the level layouts (points at u = 0 and 1),
    random d_s, every width class, an empty entry; bit-equal on a second
    launch; one launch counted."""

    @pytest.mark.parametrize("level_reso,f", [(256, 32), (256, 64), (128, 128),
                                              (64, 256), (32, 512), (64, 8), (32, 9)])
    def test_matches_plain_and_is_bit_equal(self, cuda, level_reso, f):
        inp = level_inputs(256, level_reso, f, 4, seed=43, b=3, n=3000, empty_last=True)
        pts, mask, cells = inp[:3]
        rng = np.random.default_rng(f)
        d_s = t(rng.normal(size=mask.shape + (f,)).astype(np.float32), cuda)
        xy, c, m = t(pts[..., :2], cuda), t(cells, cuda), t(mask, cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.level_d_plane(d_s, xy, c, m, level_reso, 256)
        torch.cuda.synchronize()
        _launched("level_d_plane", before)
        want = lk.level_d_plane_plain(d_s.double(), xy.double(), c, m, level_reso, 256)
        torch.testing.assert_close(got.double(), want, atol=2e-5, rtol=2e-4)
        assert (got[-1] == 0).all()
        assert torch.equal(lk.level_d_plane(d_s, xy, c, m, level_reso, 256), got)


# (R, F, Fl) of the nine K4/K5 levels of a depth-6 ALTO U-Net on the 256^2
# plane (the headline network, conf/dataset/munich.yaml)
DEPTH6_LEVELS = [(256, 32, 32), (256, 64, 32), (128, 128, 64), (64, 256, 128),
                 (32, 512, 256), (32, 512, 1024), (64, 256, 512), (128, 128, 256),
                 (256, 64, 128)]


@pytest.mark.cuda
class TestDepth6Levels:
    """K5 at every level of a depth-6 U-Net, (32, 512, 1024) included,
    against its plain backward at K5's rule (rows off the ReLU kink), and
    bit-equal on a second launch."""

    @pytest.mark.parametrize("level_reso,f,fl", DEPTH6_LEVELS)
    def test_matches_plain_and_is_bit_equal(self, cuda, level_reso, f, fl):
        inp = level_inputs(256, level_reso, f, fl, seed=47, b=2, n=4000, empty_last=True)
        args, _ = kink_free(inp, level_reso, 256, cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level_bwd(*args)
        torch.cuda.synchronize()
        _launched("fused_level_bwd", before)
        _launched("level_d_plane", before)
        _launched("level_bwd_reduce", before, 3)
        assert got[1].shape == (2, inp[1].shape[1], fl)
        assert_level_grads_close(got, lk.fused_level_bwd_plain(*args))
        again = lk.fused_level_bwd(*args)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
        assert all(torch.equal(a, b) for a, b in zip(again[2], got[2]))


def conv_weights(rng, cin, cout, k=3):
    """HWIO weights at std min(0.2, fan_in^-0.5) and small biases."""
    std = min(0.2, (k * k * cin) ** -0.5)
    return (rng.normal(0, std, (k, k, cin, cout)).astype(np.float32),
            rng.normal(0, 0.1, cout).astype(np.float32))


@pytest.mark.cuda
class TestConvKernels:
    @pytest.mark.parametrize("h,w,cin,cout,relu", [
        (24, 16, 5, 12, True), (24, 24, 3, 32, False), (16, 16, 64, 72, True),
        (32, 32, 40, 1, True)])
    def test_conv3x3_matches_plain(self, cuda, h, w, cin, cout, relu):
        rng = np.random.default_rng(0)
        x = t(rng.normal(0, 1, (2, h, w, cin)).astype(np.float32), cuda)
        k, b = (t(a, cuda) for a in conv_weights(rng, cin, cout))
        n0 = runtime.LAUNCHES["conv3x3"]
        got = ck.conv3x3(x, k, b, relu)
        want = ck.conv3x3_plain(x, k, b, relu)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["conv3x3"] == n0 + 1
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("relu", [True, False])
    @pytest.mark.parametrize("h,w,cin,cout", [
        (111, 107, 3, 32), (37, 29, 33, 72), (13, 19, 33, 130), (9, 11, 1024, 40)])
    def test_conv3x3_ragged_shapes(self, cuda, h, w, cin, cout, relu):
        """K8 on the implicit-GEMM core at batch 3, planes no tile divides:
        Cin 3 and 33 take the flat-K steps and 4-byte copies, 1024 the
        per-tap steps; 111 x 107 x 3 pixels take 128-pixel tiles, the others
        64; Cout 130 leaves a ragged second 128-channel tile."""
        rng = np.random.default_rng(8)
        x = t(rng.normal(0, 1, (3, h, w, cin)).astype(np.float32), cuda)
        k, b = (t(a, cuda) for a in conv_weights(rng, cin, cout))
        before = dict(runtime.LAUNCHES)
        got = ck.conv3x3(x, k, b, relu)
        want = ck.conv3x3_plain(x, k, b, relu)
        torch.cuda.synchronize()
        _launched("conv3x3", before)
        torch.testing.assert_close(got, want, **TOL)
        assert bool((got < 0).any()) != relu

    def test_conv3x3_unaligned_input_takes_the_scalar_copies(self, cuda):
        """A contiguous tensor whose address is 4 bytes past a 16-byte
        boundary (Cin and Cout multiples of 4): the kernel must copy it in
        4-byte steps and read nothing outside it."""
        rng = np.random.default_rng(9)
        n = 2 * 12 * 20 * 8
        x = torch.empty(n + 1, device=cuda)[1:].view(2, 12, 20, 8)
        x.copy_(t(rng.normal(0, 1, (2, 12, 20, 8)).astype(np.float32), cuda))
        buf = torch.empty(9 * 8 * 16 + 1, device=cuda)
        k = buf[1:].view(3, 3, 8, 16)
        kw, b = conv_weights(rng, 8, 16)
        k.copy_(t(kw, cuda))
        b = t(b, cuda)
        assert x.data_ptr() % 16 and k.data_ptr() % 16 and x.is_contiguous()
        got = ck.conv3x3(x, k, b, True)
        want = ck.conv3x3_plain(x, k, b, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("h,cin,cout", [(64, 32, 64), (16, 512, 1024), (96, 3, 32)])
    def test_conv3x3_is_bit_equal_run_to_run(self, cuda, h, cin, cout):
        rng = np.random.default_rng(10)
        x = t(rng.normal(0, 1, (8, h, h, cin)).astype(np.float32), cuda)
        k, b = (t(a, cuda) for a in conv_weights(rng, cin, cout))
        first = ck.conv3x3(x, k, b, False)
        for _ in range(3):
            assert torch.equal(ck.conv3x3(x, k, b, False), first)

    @pytest.mark.parametrize("h,w,cin,c1,c2,pool", [
        (24, 16, 3, 8, 12, True), (24, 24, 32, 32, 32, False), (16, 16, 64, 128, 128, True),
        (8, 8, 256, 512, 512, False), (16, 16, 512, 1024, 1024, True),
        (8, 16, 40, 36, 64, True), (12, 16, 8, 16, 320, True)])
    def test_conv_pair_matches_plain(self, cuda, h, w, cin, c1, c2, pool):
        rng = np.random.default_rng(1)
        x = t(rng.normal(0, 1, (2, h, w, cin)).astype(np.float32), cuda)
        w1, b1 = (t(a, cuda) for a in conv_weights(rng, cin, c1))
        w2, b2 = (t(a, cuda) for a in conv_weights(rng, c1, c2))
        n0 = runtime.LAUNCHES["conv_pair"]
        got = cpk.conv_pair(x, w1, b1, w2, b2, pool)
        want = cpk.conv_pair_plain(x, w1, b1, w2, b2, pool)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["conv_pair"] == n0 + 1
        torch.testing.assert_close(got[0], want[0], **TOL)
        if pool:
            torch.testing.assert_close(got[1], want[1], **TOL)
        else:
            assert got[1] is None

    @pytest.mark.parametrize("b,h,w,cin,c1,c2,pool", [
        (2, 128, 136, 8, 16, 32, True), (2, 128, 136, 32, 64, 64, True),
        (2, 128, 136, 16, 128, 128, False), (3, 12, 16, 8, 16, 320, True),
        (2, 10, 14, 5, 6, 7, True), (8, 16, 16, 64, 128, 256, True)])
    def test_conv_pair_tiles_and_odd_widths(self, cuda, b, h, w, cin, c1, c2, pool):
        """Every tile the rule picks: 128-pixel tiles where the grid has two
        blocks an SM (34816 pixels), 64 below; 32-, 64- and 128-channel
        tiles, a ragged last one at 320. Tiles span images (12 x 16 = 192
        pixels an image) and at 16^2 batch rows; odd widths take the 4-byte
        copies and stores. One form: two passes."""
        rng = np.random.default_rng(5)
        x = t(rng.normal(0, 1, (b, h, w, cin)).astype(np.float32), cuda)
        w1, b1 = (t(a, cuda) for a in conv_weights(rng, cin, c1))
        w2, b2 = (t(a, cuda) for a in conv_weights(rng, c1, c2))
        before = dict(runtime.LAUNCHES)
        got = cpk.conv_pair(x, w1, b1, w2, b2, pool)
        want = cpk.conv_pair_plain(x, w1, b1, w2, b2, pool)
        torch.cuda.synchronize()
        _launched("conv_pair", before)
        torch.testing.assert_close(got[0], want[0], **TOL)
        if pool:
            torch.testing.assert_close(got[1], want[1], **TOL)

    def test_conv_pair_pads_the_intermediate_with_zeros(self, cuda):
        """relu(b1) is 5 here: conv2's input outside the image must be 0
        (SAME padding of the intermediate), not relu(b1)."""
        rng = np.random.default_rng(6)
        x = t(rng.normal(0, 1, (2, 16, 24, 8)).astype(np.float32), cuda)
        w1, _ = (t(a, cuda) for a in conv_weights(rng, 8, 16))
        w2, b2 = (t(a, cuda) for a in conv_weights(rng, 16, 32))
        b1 = torch.full((16,), 5.0, device=cuda)
        got = cpk.conv_pair(x, w1, b1, w2, b2, True)
        want = cpk.conv_pair_plain(x, w1, b1, w2, b2, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], **TOL)
        torch.testing.assert_close(got[1], want[1], **TOL)

    @pytest.mark.parametrize("h,cin,c", [(64, 32, 64), (16, 512, 1024)])
    def test_conv_pair_is_bit_equal_run_to_run(self, cuda, h, cin, c):
        rng = np.random.default_rng(7)
        x = t(rng.normal(0, 1, (8, h, h, cin)).astype(np.float32), cuda)
        w1, b1 = (t(a, cuda) for a in conv_weights(rng, cin, c))
        w2, b2 = (t(a, cuda) for a in conv_weights(rng, c, c))
        first = cpk.conv_pair(x, w1, b1, w2, b2, True)
        for _ in range(3):
            again = cpk.conv_pair(x, w1, b1, w2, b2, True)
            assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])

    def test_conv3x3_layer_is_fp32_under_default_flags(self, cuda):
        """PyTorch runs a float32 cuDNN convolution in TF32 unless
        ``torch.backends.cudnn.allow_tf32`` is False, and True is its
        default. The port's layers run in full float32 all the same: a
        Conv3x3 at 64 channels within 1e-5 of float64 (TF32 is ~1e-3 off),
        and the caller's flag is left as it was."""
        torch.backends.cudnn.allow_tf32 = True
        try:
            torch.manual_seed(0)
            conv = Conv3x3(64, 64, relu=True).to(cuda)
            x = torch.randn(2, 64, 32, 32, device=cuda)
            got = conv(x)
            want = torch.relu(torch.nn.functional.conv2d(
                x.double(), conv.weight.double(), conv.bias.double(), padding=1))
            torch.cuda.synchronize()
            assert torch.backends.cudnn.allow_tf32
            torch.testing.assert_close(got.double(), want, **TOL)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    @pytest.mark.parametrize("h,w,cin,cout", [(24, 16, 4, 2), (64, 64, 32, 1)])
    def test_conv_decoder_matches_plain(self, cuda, h, w, cin, cout):
        rng = np.random.default_rng(2)
        x = t(rng.normal(0, 1, (2, h, w, cin)).astype(np.float32), cuda)
        ws = [conv_weights(rng, cin, 64), conv_weights(rng, 64, 128),
              conv_weights(rng, 128, 64), conv_weights(rng, cin + 256, cout, k=1)]
        args = [x] + [t(a, cuda) for pair in ws for a in pair]
        n0 = runtime.LAUNCHES["conv_decoder"]
        got = dk.conv_decoder(*args)
        want = dk.conv_decoder_plain(*args)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["conv_decoder"] == n0 + 1
        torch.testing.assert_close(got, want, **TOL)

    @staticmethod
    def _decoder_args(rng, b, h, w, c0, co, c3=64, device="cuda"):
        x = t(rng.normal(0, 1, (b, h, w, c0)).astype(np.float32), device)
        ws = [conv_weights(rng, c0, 64), conv_weights(rng, 64, 128),
              conv_weights(rng, 128, c3), conv_weights(rng, c0 + 192 + c3, co, k=1)]
        return [x] + [t(a, device) for pair in ws for a in pair]

    @pytest.mark.parametrize("c0", [3, 32, 33])
    @pytest.mark.parametrize("co", [1, 2])
    def test_conv_decoder_input_and_output_widths(self, cuda, c0, co):
        """K6's three passes at C0 3 and 33 (conv1 on the flat-K steps), 32,
        and a head of 1 or 2 outputs, at batch 3 on a 13 x 21 plane."""
        args = self._decoder_args(np.random.default_rng(11), 3, 13, 21, c0, co)
        before = dict(runtime.LAUNCHES)
        got = dk.conv_decoder(*args)
        want = dk.conv_decoder_plain(*args)
        torch.cuda.synchronize()
        _launched("conv_decoder", before)
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("b,h,w,c3", [(2, 130, 136, 64), (1, 9, 7, 64), (2, 10, 12, 20)])
    def test_conv_decoder_head_tiles(self, cuda, b, h, w, c3):
        """The head's tiles: 128 pixels where the grid has two blocks an SM
        (35360 pixels), 64 below; one 64-channel tile, ragged at C3 = 20."""
        args = self._decoder_args(np.random.default_rng(12), b, h, w, 32, 1, c3)
        got = dk.conv_decoder(*args)
        want = dk.conv_decoder_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)

    def test_conv_decoder_pads_x1_and_x2_with_zeros(self, cuda):
        """relu(b1) and relu(b2) are 5 here: the inputs of conv2 and conv3
        outside the image must be 0 (SAME padding), not relu(bias)."""
        args = self._decoder_args(np.random.default_rng(13), 2, 16, 24, 32, 1)
        args[2] = torch.full((64,), 5.0, device=cuda)
        args[4] = torch.full((128,), 5.0, device=cuda)
        got = dk.conv_decoder(*args)
        want = dk.conv_decoder_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)

    def test_conv_decoder_refuses_a_c3_one_tile_cannot_cover(self, cuda):
        args = self._decoder_args(np.random.default_rng(14), 1, 8, 8, 32, 1, c3=dk.MAX_C3 + 1)
        before = dict(runtime.LAUNCHES)
        with pytest.raises(ValueError, match="C3 = 65"):
            dk.conv_decoder(*args)
        assert runtime.LAUNCHES == before

    def test_conv_decoder_is_bit_equal_run_to_run(self, cuda):
        args = self._decoder_args(np.random.default_rng(15), 8, 64, 64, 32, 1)
        first = dk.conv_decoder(*args)
        for _ in range(3):
            assert torch.equal(dk.conv_decoder(*args), first)

    def test_backward_is_the_plain_composition(self, cuda):
        rng = np.random.default_rng(3)
        x = t(rng.normal(0, 1, (2, 16, 16, 8)).astype(np.float32), cuda).requires_grad_()
        w1, b1 = (t(a, cuda).requires_grad_() for a in conv_weights(rng, 8, 16))
        w2, b2 = (t(a, cuda).requires_grad_() for a in conv_weights(rng, 16, 16))
        y, p = cpk.conv_pair(x, w1, b1, w2, b2, True)
        (y.sum() + (p ** 2).sum()).backward()
        got = [a.grad.clone() for a in (x, w1, b1, w2, b2)]
        for a in (x, w1, b1, w2, b2):
            a.grad = None
        y, p = cpk.conv_pair_plain(x, w1, b1, w2, b2, True)
        (y.sum() + (p ** 2).sum()).backward()
        for g, a in zip(got, (x, w1, b1, w2, b2)):
            torch.testing.assert_close(g, a.grad, rtol=1e-4, atol=1e-4)

    def test_non_contiguous_input_raises(self, cuda):
        rng = np.random.default_rng(4)
        x = t(rng.normal(0, 1, (2, 3, 16, 16)).astype(np.float32), cuda).permute(0, 2, 3, 1)
        k, b = (t(a, cuda) for a in conv_weights(rng, 3, 8))
        with pytest.raises(ValueError, match="contiguous"):
            ck.conv3x3(x, k, b)


BF = torch.bfloat16


def _bf16_held(got, want, ref):
    """A bf16 conv kernel's output within 2x its bf16 plain version's
    distance from float64 plus one bf16 ulp of the output's scale."""
    ulp = 2.0 ** (float(torch.floor(torch.log2(ref.abs().max()))) - 7)
    tol = 2 * float((want.double() - ref).abs().max()) + ulp
    assert float((got.double() - ref).abs().max()) <= tol


def _bf16_weights(rng, cin, cout, device, k=3):
    """conv_weights rounded to bf16, in float32 (the model's parameters as
    K6 and K7 take them)."""
    return tuple(t(a, device).to(BF).float() for a in conv_weights(rng, cin, cout, k))


@pytest.mark.cuda
class TestBf16ConvKernels:
    """K8, K7 and K6 on bf16 activations (``t2h_*_bf16``), at the edges of
    the core's bf16 path: Cin 3, 5 and 33 on the flat-K steps with 2-byte
    loads, 8-aligned Cin on 16-byte copies of 8 channels, Cout 130 (a ragged
    128-channel tile) and 7 (2-byte weight loads, scalar stores). K8 takes
    that path where Cin or Cout is not a multiple of 8 or x is unaligned;
    its other cases run on ``csrc/conv_bf16.cu``'s wgmma route."""

    @pytest.mark.parametrize("relu", [True, False])
    @pytest.mark.parametrize("h,w,cin,cout", [
        (111, 107, 3, 32), (37, 29, 33, 72), (13, 19, 64, 130), (9, 11, 1024, 40),
        (24, 16, 5, 7), (16, 16, 8, 64)])
    def test_conv3x3_matches_plain(self, cuda, h, w, cin, cout, relu):
        rng = np.random.default_rng(20)
        x = t(rng.normal(0, 1, (3, h, w, cin)).astype(np.float32), cuda).to(BF)
        k, b = (t(a, cuda) for a in conv_weights(rng, cin, cout))
        k = k.to(BF)
        before = dict(runtime.LAUNCHES)
        got = ck.conv3x3(x, k, b, relu)
        want = ck.conv3x3_plain(x, k, b, relu)
        torch.cuda.synchronize()
        _launched("conv3x3_bf16", before)
        assert got.dtype == BF and torch.equal(ck.conv3x3(x, k, b, relu), got)
        _bf16_held(got, want, ck.conv3x3_plain(x.double(), k.double(), b.double(), relu))

    def test_conv3x3_unaligned_input_takes_the_scalar_copies(self, cuda):
        rng = np.random.default_rng(21)
        n = 2 * 12 * 20 * 16
        x = torch.empty(n + 1, device=cuda, dtype=BF)[1:].view(2, 12, 20, 16)
        x.copy_(t(rng.normal(0, 1, (2, 12, 20, 16)).astype(np.float32), cuda))
        kw, b = conv_weights(rng, 16, 16)
        k, b = t(kw, cuda).to(BF), t(b, cuda)
        assert x.data_ptr() % 16 and x.is_contiguous()
        got = ck.conv3x3(x, k, b, True)
        want = ck.conv3x3_plain(x, k, b, True)
        torch.cuda.synchronize()
        _bf16_held(got, want, ck.conv3x3_plain(x.double(), k.double(), b.double(), True))

    @pytest.mark.parametrize("b,h,w,cin,c1,c2,pool", [
        (2, 24, 16, 3, 8, 12, True), (2, 128, 136, 32, 64, 64, True),
        (8, 16, 16, 512, 1024, 1024, True), (3, 12, 16, 8, 16, 320, True),
        (2, 10, 14, 5, 6, 7, True), (2, 24, 24, 32, 32, 32, False)])
    def test_conv_pair_matches_plain(self, cuda, b, h, w, cin, c1, c2, pool):
        rng = np.random.default_rng(22)
        x = t(rng.normal(0, 1, (b, h, w, cin)).astype(np.float32), cuda).to(BF)
        args = (x, *_bf16_weights(rng, cin, c1, cuda), *_bf16_weights(rng, c1, c2, cuda))
        before = dict(runtime.LAUNCHES)
        got = cpk.conv_pair(*args, pool)
        want = cpk.conv_pair_plain(*args, pool)
        ref = cpk.conv_pair_plain(*(a.double() for a in args), pool)
        torch.cuda.synchronize()
        _launched("conv_pair_bf16", before)
        for i in (0, 1) if pool else (0,):
            assert got[i].dtype == BF
            _bf16_held(got[i], want[i], ref[i])

    @pytest.mark.parametrize("c0,co,c3", [(3, 1, 64), (32, 1, 64), (33, 2, 20)])
    def test_conv_decoder_matches_plain(self, cuda, c0, co, c3):
        rng = np.random.default_rng(23)
        x = t(rng.normal(0, 1, (3, 13, 21, c0)).astype(np.float32), cuda).to(BF)
        args = (x, *_bf16_weights(rng, c0, 64, cuda), *_bf16_weights(rng, 64, 128, cuda),
                *_bf16_weights(rng, 128, c3, cuda),
                *_bf16_weights(rng, c0 + 192 + c3, co, cuda, k=1))
        before = dict(runtime.LAUNCHES)
        got = dk.conv_decoder(*args)
        want = dk.conv_decoder_plain(*args)
        torch.cuda.synchronize()
        _launched("conv_decoder_bf16", before)
        assert got.dtype == torch.float32 and torch.equal(dk.conv_decoder(*args), got)
        _bf16_held(got, want, dk.conv_decoder_plain(*(a.double() for a in args)))

    def test_backward_is_the_f32_composition(self, cuda):
        """bf16 in, each gradient in its input's dtype: x's bf16, the f32
        weights' f32, as the f32 composition's autograd on the upcast inputs
        gives them for the same cotangents."""
        rng = np.random.default_rng(24)
        x = t(rng.normal(0, 1, (2, 16, 16, 8)).astype(np.float32), cuda).to(BF)
        ws = [a.requires_grad_() for a in (*_bf16_weights(rng, 8, 16, cuda),
                                           *_bf16_weights(rng, 16, 16, cuda))]
        x.requires_grad_()
        y, p = cpk.conv_pair(x, *ws, True)
        gy, gp = torch.ones_like(y), p.detach().clone()
        torch.autograd.backward([y, p], [gy, gp])
        got = [a.grad for a in (x, *ws)]
        leaves = [a.detach().float().requires_grad_() for a in (x, *ws)]
        y32, p32 = cpk.conv_pair_plain(*leaves, True)
        want = torch.autograd.grad([y32, p32], leaves, [gy.float(), gp.float()])
        assert got[0].dtype == BF and all(a.dtype == torch.float32 for a in got[1:])
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.to(a.dtype).float(), rtol=1e-2, atol=1e-3)

    def test_mixed_dtypes_raise(self, cuda):
        rng = np.random.default_rng(25)
        x = t(rng.normal(0, 1, (2, 8, 8, 8)).astype(np.float32), cuda)
        k, b = (t(a, cuda) for a in conv_weights(rng, 8, 8))
        with pytest.raises(TypeError, match="dtype"):
            ck.conv3x3(x.to(BF), k, b)  # K8 takes the kernel in x's dtype
        with pytest.raises(TypeError, match="dtype"):
            ck.conv3x3(x.to(BF), k.to(BF), b.to(BF))  # and the bias in f32
        with pytest.raises(TypeError, match="dtype"):
            cpk.conv_pair(x.to(BF), k.to(BF), b, k.to(BF), b)  # K7 takes f32 weights
        with pytest.raises(TypeError, match="dtype"):
            ck.conv3x3(x.half(), k.half(), b)


def _launched(name, before, n=1):
    assert runtime.LAUNCHES[name] == before[name] + n, name


@pytest.mark.cuda
class TestTileKernels:
    """K9-K14 (the ``fused``/``pallas`` paths' kernels) at the edge cases of
    tests/test_pallas_aligned.py and tests/test_pallas_kernel.py."""

    @pytest.mark.parametrize("reso,finest,edge", [
        (64, 64, "none"), (32, 64, "empty"), (32, 32, "border"), (256, 256, "none")])
    def test_tile_gather(self, cuda, reso, finest, edge):
        pts, mask, _, toff, _ = tile_batch(13, reso=finest, edge=edge)
        rng = np.random.default_rng(1)
        plane = t(rng.normal(size=(2, reso, reso, 48)).astype(np.float32), cuda)
        xy = t(pts[..., :2], cuda)
        lvl_toff = t(toff[:, :: 4 ** ((finest.bit_length() - reso.bit_length()))], cuda)
        before = dict(runtime.LAUNCHES)
        got = gk.tile_gather(plane, xy, lvl_toff)
        want = gk.tile_gather_plain(plane, xy, lvl_toff)
        torch.cuda.synchronize()
        _launched("tile_gather", before)
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("kind", ["max", "mean"])
    @pytest.mark.parametrize("edge", ["none", "one_cell", "empty"])
    def test_tile_pool(self, cuda, kind, edge):
        _, mask, cells, toff, vals = tile_batch(41, f=40, edge=edge)
        v, c, tt = t(vals, cuda), t(cells, cuda), t(toff, cuda)
        before = dict(runtime.LAUNCHES)
        got = tpk.tile_pool(v, c, tt, kind)
        want = tpk.tile_pool_plain(v, c, tt, kind)
        torch.cuda.synchronize()
        _launched("tile_pool", before)
        torch.testing.assert_close(got, want, **TOL)
        assert (got[t(~mask, cuda)] == 0).all()

    @pytest.mark.parametrize("reso,finest,f,edge", [
        (64, 64, 32, "none"), (32, 64, 40, "empty"), (16, 64, 1024, "none"),
        (64, 64, 8, "one_cell")])
    def test_aligned_scatter_mean_plane(self, cuda, reso, finest, f, edge):
        _, _, cells, toff, vals = tile_batch(7, reso=finest, f=f, edge=edge)
        level = finest.bit_length() - reso.bit_length()
        v, c = t(vals, cuda), t(cells, cuda)
        lvl_toff = t(toff[:, :: 4 ** level], cuda)
        before = dict(runtime.LAUNCHES)
        got = sk.aligned_scatter_mean_plane(v, c, lvl_toff, reso, finest)
        want = sk.aligned_scatter_mean_plane_plain(v, c, lvl_toff, reso, finest)
        got_v3 = sk.scatter_mean_plane_v3(v, c, t(toff, cuda), reso, finest)
        torch.cuda.synchronize()
        _launched("aligned_scatter_mean_plane", before)
        _launched("scatter_mean_plane_v3", before)
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(got_v3, want, **TOL)
        # K14 on the run scatter: bit-equal on a second launch
        assert torch.equal(sk.scatter_mean_plane_v3(v, c, t(toff, cuda), reso, finest), got_v3)
        if edge == "empty":
            assert (got[-1] == 0).all()

    @pytest.mark.parametrize("reso,f,one_cell", [(32, 8, False), (16, 4, False),
                                                 (16, 4, True), (64, 96, False)])
    def test_sorted_scatter_mean(self, cuda, reso, f, one_cell):
        vals, cells, offs = sorted_batch(3, reso=reso, f=f, one_cell=one_cell)
        v, c, o = t(vals, cuda), t(cells, cuda), t(offs, cuda)
        before = dict(runtime.LAUNCHES)
        plane = sk.scatter_mean_plane(v, c, o, reso)
        vec = sk.scatter_mean(v, c, o, reso)
        torch.cuda.synchronize()
        _launched("scatter_mean_plane", before)
        _launched("scatter_mean", before)
        torch.testing.assert_close(plane, sk.scatter_mean_plane_plain(v, c, o, reso), **TOL)
        torch.testing.assert_close(vec, sk.scatter_mean_plain(v, c, o, reso), **TOL)

    def test_forward_only_kernels_refuse_a_gradient(self, cuda):
        vals, cells, offs = sorted_batch(3)
        v = t(vals, cuda).requires_grad_()
        with pytest.raises(RuntimeError, match="forward-only"):
            sk.scatter_mean_plane(v, t(cells, cuda), t(offs, cuda), 32)

    def test_backwards_are_the_plain_compositions(self, cuda):
        pts, mask, cells, toff, vals = tile_batch(21, f=16)
        vals[~mask] = 0.0
        m, c, tt = t(mask, cuda), t(cells, cuda), t(toff, cuda)
        rng = np.random.default_rng(2)
        plane = t(rng.normal(size=(2, RESO, RESO, 16)).astype(np.float32), cuda)
        xy = t(pts[..., :2], cuda)

        def grads(on_kernel):
            p = plane.clone().requires_grad_()
            v = t(vals, cuda).requires_grad_()
            if on_kernel:
                s = fused.tile_gather(p, xy, m, c, tt, RESO, RESO)
                q = fused.tile_pool(v, c, tt, m, RESO, "max")
                o = fused.tile_scatter_mean(v, c, tt, RESO, RESO)
            else:
                s = fused._masked(m, grid_sample_2d(p, xy))
                q = fused._masked(m, tpk.tile_pool_plain(v, c, tt, "max"))
                o = sk.aligned_scatter_mean_plane_plain(v, c, tt, RESO, RESO)
            ((s ** 2).sum() + (q * v).sum() + (o ** 2).sum()).backward()
            return p.grad, v.grad

        before = dict(runtime.LAUNCHES)
        got = grads(True)
        want = grads(False)
        torch.cuda.synchronize()
        for name in ("tile_gather", "tile_pool", "aligned_scatter_mean_plane",
                     "tile_gather_bwd", "tile_pool_bwd", "aligned_scatter_mean_plane_bwd"):
            _launched(name, before)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
class TestHeadlineStep:
    """One mini-step of the headline network (``headline_config``: ALTO depth
    6, the image U-Net, the footprint head) at full width on 2 patches: the
    kernel path (fused2 + K6/K7) launches what
    ``chip_smoke.HEADLINE_TRAIN_LAUNCHES`` counts, the plain path (unsorted,
    kernel flags off) none; from the same weights on the same points their
    loss_l1 agree within the smoke's 2e-4 * z_scale, loss_ce within 2e-4 *
    weight_ce, and their gradients within 1e-3 of the gradient's norm over
    all parameters and 1e-2 of each tensor's (the paths add in other orders,
    and a ReLU gate within rounding of its kink may open on one path only)."""

    def test_kernel_step_matches_plain(self, cuda):
        import chip_smoke as cs
        from tomosar2height_tpu_torch.config import headline_config
        from tomosar2height_tpu_torch.models import build_model, init_weights
        from tomosar2height_tpu_torch.ops.cuda.conv_kernel import fp32_convs
        from tomosar2height_tpu_torch.train import Trainer

        cfg = headline_config()
        model = init_weights(build_model(cfg, "cuda"), torch.Generator().manual_seed(0))
        plain_cfg = headline_config()
        plain_cfg["model"]["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = False
        plain_cfg["model"]["encoder2_kwargs"]["fused_convs"] = False
        plain_cfg["model"]["decoder_pixel_kwargs"]["fused_head"] = False
        plain = build_model(plain_cfg, "cuda")
        plain.load_state_dict(model.state_dict())
        pts, mask, apts, amask, _, toff = cs.flagship_batch(1, b=2)
        rng = np.random.default_rng(2)
        side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
        common = {"image": rng.normal(0, 1, (2, side, side, 3)).astype(np.float32),
                  "dsm": np.where(rng.random((2, side, side)) < 0.5, 0.0,
                                  rng.uniform(1, 40, (2, side, side))).astype(np.float32),
                  "patch_valid": np.ones(2, bool)}
        tcfg = cfg["training"]

        def step(m, batch):
            trainer = Trainer(m, tcfg, use_image=True, use_footprint=True,
                              weight_ce=tcfg["weight_ce"])
            dev = trainer.prepare_batch(batch)
            runtime.reset_launches()
            with fp32_convs(deterministic=True):
                loss, metrics = trainer.loss(dev)
                grads = torch.autograd.grad(loss, trainer.params)
            torch.cuda.synchronize()
            launched = {k: v for k, v in runtime.LAUNCHES.items() if v}
            return {k: float(v) for k, v in metrics.items()}, grads, launched

        km, kg, kl = step(model, {"points": apts, "point_mask": amask, "cell_offsets": toff,
                                  **common})
        assert kl == cs.HEADLINE_TRAIN_LAUNCHES
        pm, pg, pl = step(plain, {"points": pts, "point_mask": mask, **common})
        assert pl == {}
        z = cfg["dataset"]["normalize"]["z_bound"]
        assert abs(km["loss_l1"] - pm["loss_l1"]) <= 2e-4 * (z[1] - z[0]), (km, pm)
        assert abs(km["loss_ce"] - pm["loss_ce"]) <= 2e-4 * tcfg["weight_ce"], (km, pm)
        names = [n for n, _ in model.named_parameters()]
        err = {n: float((a - b).norm()) for n, a, b in zip(names, kg, pg)}
        ref = {n: float(b.norm()) for n, b in zip(names, pg)}
        worst = max(names, key=lambda n: err[n] / max(ref[n], 1e-30))
        total = np.sqrt(sum(e ** 2 for e in err.values()) / sum(r ** 2 for r in ref.values()))
        assert total <= 1e-3, (total, worst, err[worst] / ref[worst])
        assert err[worst] <= 1e-2 * ref[worst], (worst, err[worst], ref[worst])


@pytest.mark.cuda
class TestFusedBackwards:
    """The ``fused`` layout's backwards on the card: K9's (K5's d_plane pass),
    K10's (the run kernel, max's cotangent split among tied rows) and K12's
    (K2 alone at the level's shift) against their plain versions, on layouts
    with an empty entry and cells whose max ties, each bit-equal on a second
    launch; then one ``fused`` training mini-step at full width against the
    unsorted plain path, and its gradients bit-equal on a rerun."""

    @pytest.mark.parametrize("reso,finest,edge", [(64, 64, "empty"), (32, 64, "border"),
                                                  (32, 32, "one_cell")])
    def test_tile_gather_bwd(self, cuda, reso, finest, edge):
        pts, mask, cells, _, _ = tile_batch(5, n=800, reso=finest, f=24, edge=edge)
        g = torch.randn(*mask.shape, 24, generator=torch.Generator().manual_seed(3))
        args = (g.to(cuda), t(pts[..., :2].copy(), cuda), t(cells, cuda), t(mask, cuda), reso,
                finest)
        before = dict(runtime.LAUNCHES)
        got = gk.tile_gather_bwd(*args)
        again = gk.tile_gather_bwd(*args)
        torch.cuda.synchronize()
        _launched("tile_gather_bwd", before, 2)
        assert torch.equal(got, again)
        torch.testing.assert_close(got, lk.level_d_plane_plain(*args), rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("impl,reso", [("cumsum", 256), ("cumsum", 32), ("fused", 16)])
    def test_sorted_sample_bwd(self, cuda, impl, reso):
        """``fused.sorted_sample``'s backward, K5's d_plane pass, on the plain
        sorted layout (pads at the end, id 256^2) and on the aligned layout
        of 256-cell tiles below 32^2: against the plain transpose of the
        masked cotangent, bit-equal on a second backward."""
        import chip_smoke as cs
        from tomosar2height_tpu_torch.ops import fused

        pts, mask, apts, amask, acells, _ = cs.flagship_batch(2, b=2, n=4000, tile_cells=256)
        if impl == "cumsum":
            apts, amask, acells, _ = cs.sorted_layout(pts, mask)
        xy, m, c = t(apts[..., :2].copy(), cuda), t(amask, cuda), t(acells, cuda)
        gen = torch.Generator().manual_seed(5)
        plane = torch.randn(2, reso, reso, 40, generator=gen).to(cuda).requires_grad_()
        g = torch.randn(*amask.shape, 40, generator=gen).to(cuda)
        before = dict(runtime.LAUNCHES)
        got, again = (torch.autograd.grad(fused.sorted_sample(plane, xy, m, c, 256), plane, g)[0]
                      for _ in range(2))
        torch.cuda.synchronize()
        _launched("level_d_plane", before, 2)
        assert torch.equal(got, again)
        torch.testing.assert_close(got, lk.level_d_plane_plain(g, xy, c, m, reso, 256),
                                   rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("kind,ties", [("max", False), ("max", True), ("mean", False)])
    def test_tile_pool_bwd(self, cuda, kind, ties):
        _, mask, cells, toff, vals = tile_batch(11, n=900, reso=64, f=40, edge="empty")
        if ties:
            vals = np.where(mask[..., None], np.random.default_rng(4).integers(0, 3, vals.shape),
                            vals).astype(np.float32)
        v, c, tt = t(vals, cuda), t(cells, cuda), t(toff, cuda)
        g = (torch.randn(vals.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
             * t(mask, cuda)[..., None]).contiguous()
        out = tpk.tile_pool(v, c, tt, kind)
        before = dict(runtime.LAUNCHES)
        got = tpk.tile_pool_bwd(g, v, out, c, tt, kind)
        again = tpk.tile_pool_bwd(g, v, out, c, tt, kind)
        torch.cuda.synchronize()
        _launched("tile_pool_bwd", before, 2)
        assert torch.equal(got, again)
        torch.testing.assert_close(got, tpk.tile_pool_bwd_plain(g, v, out, c, tt, kind), **TOL)

    @pytest.mark.parametrize("reso", [64, 32, 16])
    def test_tile_scatter_bwd(self, cuda, reso):
        _, _, cells, toff, vals = tile_batch(7, n=900, reso=64, f=24, edge="empty")
        lvl = t(toff[:, :: 4 ** (64 .bit_length() - reso.bit_length())], cuda)
        c = t(cells, cuda)
        _, counts = sk.aligned_scatter_mean_plane(t(vals, cuda), c, lvl, reso, 64,
                                                  with_counts=True)
        _, want_counts = sk.aligned_scatter_mean_plane_plain(t(vals, cuda), c, lvl, reso, 64,
                                                             with_counts=True)
        assert torch.equal(counts, want_counts)
        g = torch.randn(2, reso, reso, 24, generator=torch.Generator().manual_seed(6)).to(cuda)
        before = dict(runtime.LAUNCHES)
        got = sk.aligned_scatter_mean_plane_bwd(g, c, counts, reso, 64)
        again = sk.aligned_scatter_mean_plane_bwd(g, c, counts, reso, 64)
        torch.cuda.synchronize()
        _launched("aligned_scatter_mean_plane_bwd", before, 2)
        _launched("pool_gather", before, 2)
        assert torch.equal(got, again)
        torch.testing.assert_close(
            got, sk.aligned_scatter_mean_plane_bwd_plain(g, c, counts, reso, 64), **TOL)

    @pytest.mark.parametrize("impl", ["fused", "cumsum"])
    def test_sorted_step_matches_plain_and_repeats(self, cuda, impl):
        """The flagship at full width on 2 patches: the ``fused`` path
        launches what ``chip_smoke.SORTED_TRAIN_LAUNCHES`` counts (``cumsum``
        what ``CUMSUM_TRAIN_LAUNCHES`` counts: its samples' backward on K5's
        d_plane pass), its loss is the plain path's within 2e-4 * z_scale and its
        gradients within 1e-3 of the gradient's norm overall and 1e-2 of each
        tensor's; a second step from the same weights gives the same
        gradients, bit for bit (``cumsum``: its segment sums, gather-backs
        and samples differentiate in a fixed order)."""
        import chip_smoke as cs
        from tomosar2height_tpu_torch.config import sorted_config
        from tomosar2height_tpu_torch.models import build_model, init_weights
        from tomosar2height_tpu_torch.ops.cuda.conv_kernel import fp32_convs
        from tomosar2height_tpu_torch.train import Trainer

        cfg = sorted_config(impl)
        model = init_weights(build_model(cfg, "cuda"), torch.Generator().manual_seed(0))
        pts, mask, apts, amask, _, toff = cs.flagship_batch(1, b=2, tile_cells=256)
        if impl == "cumsum":
            apts, amask, _, toff = cs.sorted_layout(pts, mask)
        side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
        rng = np.random.default_rng(2)
        common = {"dsm": rng.uniform(0, 40, (2, side, side)).astype(np.float32),
                  "patch_valid": np.ones(2, bool)}

        def step(batch):
            trainer = Trainer(model, cfg["training"])
            dev = trainer.prepare_batch(batch)
            runtime.reset_launches()
            with fp32_convs(deterministic=True):
                loss, _ = trainer.loss(dev)
                grads = torch.autograd.grad(loss, trainer.params)
            torch.cuda.synchronize()
            return float(loss), grads, {k: v for k, v in runtime.LAUNCHES.items() if v}

        fused = {"points": apts, "point_mask": amask, "cell_offsets": toff, **common}
        kl, kg, launched = step(fused)
        assert launched == (cs.SORTED_TRAIN_LAUNCHES if impl == "fused"
                            else cs.CUMSUM_TRAIN_LAUNCHES)
        _, kg2, _ = step(fused)
        assert all(torch.equal(a, b) for a, b in zip(kg, kg2))
        pl, pg, plain_launched = step({"points": pts, "point_mask": mask, **common})
        assert plain_launched == {}
        z = cfg["dataset"]["normalize"]["z_bound"]
        assert abs(kl - pl) <= 2e-4 * (z[1] - z[0]), (kl, pl)
        names = [n for n, _ in model.named_parameters()]
        err = {n: float((a - b).norm()) for n, a, b in zip(names, kg, pg)}
        ref = {n: float(b.norm()) for n, b in zip(names, pg)}
        worst = max(names, key=lambda n: err[n] / max(ref[n], 1e-30))
        total = np.sqrt(sum(e ** 2 for e in err.values()) / sum(r ** 2 for r in ref.values()))
        assert total <= 1e-3, (total, worst, err[worst] / ref[worst])
        assert err[worst] <= 1e-2 * ref[worst], (worst, err[worst], ref[worst])


@pytest.mark.cuda
def test_u16_points_dequantize_on_the_card(cuda):
    """The u16 wire's upload and its one f32 multiply on the card give the
    host's dequantized coordinates, bit for bit."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import (
        dequantize_points,
        dequantize_points_np,
    )

    q = np.random.default_rng(0).integers(0, 65536, (4, 1000, 3)).astype(np.uint16)
    dev = torch.from_numpy(q).pin_memory().to(cuda, non_blocking=True)
    got = dequantize_points(dev).cpu().numpy()
    np.testing.assert_array_equal(got, dequantize_points_np(q))


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of want (2^-7 of the power of
    two at or below |want|), the ulp floored at 2^-16 of want's scale, where
    a sum cancels and two f32 orders leave more than an ulp of it."""
    w = want.double()
    floor = 2.0 ** -16 * float(w.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.double() - w).abs() / ulp.clamp_min(floor)).max())


def bf16_level_held(got, want, ref):
    """K4's and K5's bf16 rule (tests/test_fused_level_bwd.py:184-190): the
    kernel no further from ``ref``, the plain version in float32 on the same
    bf16 operands, than max(1.5x the bf16 plain version's distance, 0.02 x
    scale), and no further than that from the bf16 plain version."""
    r = ref.double()
    bound = max(1.5 * float((want.double() - r).abs().max()),
                0.02 * float(r.abs().max()) + 1e-12)
    assert got.dtype == want.dtype == BF
    assert float((got.double() - r).abs().max()) <= bound
    assert float((got.double() - want.double()).abs().max()) <= bound


def _bf(x, device):
    return t(x, device).to(BF)


@pytest.mark.cuda
class TestBf16RunAndLevelKernels:
    """K1-K5's bf16 instances (``t2h_*_bf16``, counted under ``*_bf16``)
    against their bf16 plain versions: the run kernels and K2 within one
    bf16 ulp (their f32 sums in another order, each output rounded once;
    max exact; K2 alone bit-equal, one division rounded), K4 and K5 under
    the JAX package's bf16 rule (``bf16_level_held``), K5's d_plane pass and
    weight sums within one bf16 ulp; each bit-equal on a second launch."""

    @pytest.mark.parametrize("f", [8, 40, 128])
    @pytest.mark.parametrize("kind", ["max", "mean", "sum"])
    def test_pool2_matches_plain(self, cuda, kind, f):
        _, mask, cells, _, vals = run_batch(6, f=f)
        v, c, m = _bf(vals, cuda), t(cells, cuda), t(mask, cuda)
        before = dict(runtime.LAUNCHES)
        got = pk.pool2_fwd(v, c, m, RESO, kind)
        want = pk.pool2_plain(v, c, m, RESO, kind)
        torch.cuda.synchronize()
        _launched("pool2_bf16", before)
        assert runtime.LAUNCHES["pool2"] == before["pool2"]
        assert got.dtype == BF and torch.equal(pk.pool2_fwd(v, c, m, RESO, kind), got)
        if kind == "max":
            assert torch.equal(got, want)
        else:
            assert bf16_ulps(got, want) <= 1

    @pytest.mark.parametrize("holes", [False, True])
    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_pool2_backward_matches_plain(self, cuda, kind, holes):
        _, mask, cells, _, vals = run_batch(7, f=40, holes=holes)
        v, c, m = _bf(vals, cuda), t(cells, cuda), t(mask, cuda)
        g = torch.randn(v.shape, generator=torch.Generator().manual_seed(4)).to(cuda, BF)
        out = pk.pool2(v, c, m, RESO, kind)
        before = dict(runtime.LAUNCHES)
        got = pk.pool2_bwd(g, v, out, c, m, RESO, kind)
        want = pk.pool2_bwd_plain(g, v, out, c, m, RESO, kind)
        torch.cuda.synchronize()
        _launched("pool2_bwd_bf16", before)
        assert got.dtype == BF and torch.equal(pk.pool2_bwd(g, v, out, c, m, RESO, kind), got)
        assert bf16_ulps(got, want) <= 1

    @pytest.mark.parametrize("f", [8, 40, 64, 128])
    def test_scatter_plane2_matches_plain(self, cuda, f):
        """F 8 and 40: a lane a feature; 64: two; 128: four (8-byte loads)."""
        _, mask, cells, _, vals = run_batch(8, f=f)
        v, c, m = _bf(vals, cuda), t(cells, cuda), t(mask, cuda)
        before = dict(runtime.LAUNCHES)
        plane, counts = pk.scatter_plane2(v, c, m, RESO)
        want_plane, want_counts = pk.scatter_plane2_plain(v, c, m, RESO)
        torch.cuda.synchronize()
        _launched("scatter_plane2_bf16", before)
        assert plane.dtype == BF and torch.equal(counts, want_counts)
        assert bf16_ulps(plane, want_plane) <= 1
        again = pk.scatter_plane2(v, c, m, RESO)
        assert torch.equal(again[0], plane) and torch.equal(again[1], counts)
        g = torch.randn(plane.shape, generator=torch.Generator().manual_seed(5)).to(cuda, BF)
        before = dict(runtime.LAUNCHES)
        dv = pk.scatter_plane2_bwd(g, c, m, counts)
        torch.cuda.synchronize()
        _launched("pool_gather_bf16", before)
        assert dv.dtype == BF and torch.equal(dv, pk.scatter_plane2_bwd_plain(g, c, m, counts))

    @pytest.mark.parametrize("reso,level_reso,f,fl", [
        (64, 64, 8, 4), (64, 32, 16, 16), (32, 32, 8, 8), (256, 32, 512, 256),
        (256, 32, 512, 1024), (64, 32, 64, 600), (256, 128, 128, 64)])
    def test_level_matches_plain(self, cuda, reso, level_reso, f, fl):
        """Fl 4 and 600 take the 2-byte copies of c_last; F 8 a warp's one
        n8 tile."""
        inp = level_inputs(reso, level_reso, f, fl, seed=27, empty_last=True)
        pts, mask, cells, _, plane, c_last, weights = inp
        args = (_bf(plane, cuda), _bf(c_last, cuda), tuple(_bf(w, cuda) for w in weights),
                t(pts[..., :2], cuda), t(cells, cuda), t(mask, cuda), level_reso, reso)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level(*args)
        want = lk.fused_level_plain(*args)
        ref = lk.fused_level_plain(args[0].float(), args[1].float(),
                                   tuple(w.float() for w in args[2]), *args[3:])
        torch.cuda.synchronize()
        _launched("fused_level_bf16", before)
        _launched("fused_level_scatter_bf16", before)
        assert runtime.LAUNCHES["fused_level"] == before["fused_level"]
        for i in (0, 1):
            bf16_level_held(got[i], want[i], ref[i])
        assert torch.equal(got[2], want[2]) and (got[1][-1] == 0).all()
        assert all(torch.equal(a, b) for a, b in zip(lk.fused_level(*args), got))

    @pytest.mark.parametrize("reso,level_reso,f,fl", [
        (64, 64, 8, 4), (64, 32, 16, 16), (32, 32, 8, 8), (256, 32, 512, 256),
        (256, 64, 256, 512), (256, 32, 512, 1024)])
    def test_level_backward_matches_plain(self, cuda, reso, level_reso, f, fl):
        inp = level_inputs(reso, level_reso, f, fl, seed=29, empty_last=True)
        pts, mask, cells, _, plane, c_last, weights = inp
        g_p, g_c = level_cotangents(inp, seed=7)
        fwd = (_bf(plane, cuda), _bf(c_last, cuda), tuple(_bf(w, cuda) for w in weights),
               t(pts[..., :2], cuda), t(cells, cuda), t(mask, cuda))
        counts = lk.fused_level(*fwd, level_reso, reso)[2]
        args = fwd + (counts, _bf(g_p, cuda), _bf(g_c, cuda), level_reso, reso)
        up = tuple(tuple(w.float() for w in a) if isinstance(a, tuple) else
                   a.float() if torch.is_tensor(a) and a.dtype == BF else a for a in args)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level_bwd(*args)
        want = lk.fused_level_bwd_plain(*args)
        ref = lk.fused_level_bwd_plain(*up)
        torch.cuda.synchronize()
        _launched("fused_level_bwd_bf16", before)
        _launched("level_d_plane_bf16", before)
        _launched("level_bwd_reduce_bf16", before, 3)
        flat = lambda x: [x[0], x[1], *x[2]]  # noqa: E731
        for a, b, r in zip(flat(got), flat(want), flat(ref)):
            bf16_level_held(a, b, r)
        again = lk.fused_level_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(flat(again), flat(got)))

    @pytest.mark.parametrize("level_reso,f", [(256, 32), (256, 64), (128, 128), (32, 512),
                                              (32, 9)])
    def test_d_plane_matches_plain(self, cuda, level_reso, f):
        inp = level_inputs(256, level_reso, f, 4, seed=47, b=3, n=3000, empty_last=True)
        pts, mask, cells = inp[:3]
        rng = np.random.default_rng(f)
        d_s = _bf(rng.normal(size=mask.shape + (f,)).astype(np.float32), cuda)
        xy, c, m = t(pts[..., :2], cuda), t(cells, cuda), t(mask, cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.level_d_plane(d_s, xy, c, m, level_reso, 256)
        want = lk.level_d_plane_plain(d_s, xy, c, m, level_reso, 256)
        torch.cuda.synchronize()
        _launched("level_d_plane_bf16", before)
        assert got.dtype == BF and bf16_ulps(got, want) <= 1 and (got[-1] == 0).all()
        assert torch.equal(lk.level_d_plane(d_s, xy, c, m, level_reso, 256), got)

    @pytest.mark.parametrize("m,ka,nb,bias", [
        (50001, 32, 32, True), (20011, 1024, 512, False), (4099, 512, 1024, True),
        (777, 33, 65, True), (163843, 32, 1024, True)])
    def test_reduce_matches_plain(self, cuda, m, ka, nb, bias):
        """Ka 33 and Nb 65 take the 2-byte copies; each output within one
        bf16 ulp of its scale (f32 sums in two orders, rounded once)."""
        rng = np.random.default_rng(m + ka)
        a = _bf(rng.normal(size=(m, ka)).astype(np.float32), cuda)
        b = _bf(rng.normal(size=(m, nb)).astype(np.float32), cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.level_bwd_reduce(a, b, bias)
        want = lk.level_bwd_reduce_plain(a, b, bias)
        torch.cuda.synchronize()
        _launched("level_bwd_reduce_bf16", before)
        for x, y in zip(got, want):
            if y is not None:
                ulp = 2.0 ** (float(torch.floor(torch.log2(y.float().abs().max()))) - 7)
                assert x.dtype == BF and float((x.float() - y.float()).abs().max()) <= ulp
        again = lk.level_bwd_reduce(a, b, bias)
        assert all(y is None or torch.equal(x, y) for x, y in zip(again, got))

    def test_autograd_runs_the_bf16_kernels(self, cuda):
        inp = level_inputs(64, 32, 16, 16, seed=4)
        pts, mask, cells, _, plane, c_last, weights = inp
        p = _bf(plane, cuda).requires_grad_()
        w = tuple(_bf(x, cuda).requires_grad_() for x in weights)
        v = _bf(np.random.default_rng(0).normal(size=mask.shape + (16,)), cuda)
        v.requires_grad_()
        c, m = t(cells, cuda), t(mask, cuda)
        before = dict(runtime.LAUNCHES)
        c_last = pk.pool2(v, c, m, 64, "max")
        po, co, _ = lk.fused_level(p, c_last, w, t(pts[..., :2], cuda), c, m, 32, 64)
        plane2, _ = pk.scatter_plane2(co, c, m, 64)
        (po.float().sum() + plane2.float().sum()).backward()
        torch.cuda.synchronize()
        for name in ("pool2", "fused_level", "scatter_plane2", "pool2_bwd", "fused_level_bwd",
                     "scatter_plane2_bwd"):
            _launched(f"{name}_bf16", before)
            assert runtime.LAUNCHES[name] == before[name]
        assert all(x.grad.dtype == BF and torch.isfinite(x.grad.float()).all()
                   for x in (p, v, *w))


@pytest.mark.cuda
class TestBf16TileKernels:
    """K9-K14's bf16 modes and the backwards of the ``fused`` and ``cumsum``
    layouts in bf16 (counted under ``*_bf16``, no f32 launch) against their
    bf16 plain versions: K9, K11-K14 and the means within one bf16 ulp (f32
    sums in another order, each output rounded once; K9's four products in
    the plain version's order, measured bit-equal), max exact; K12's
    backward (the count cut to bf16, one division rounded) bit-equal; the
    d_plane passes within one bf16 ulp; each bit-equal on a second launch.
    Then a bf16 mini-step of the flagship on ``fused`` and on ``cumsum``:
    the launches ``chip_smoke`` counts, its gradients bit-equal on a rerun."""

    @pytest.mark.parametrize("reso,finest,edge", [
        (64, 64, "none"), (32, 64, "empty"), (32, 32, "border"), (256, 256, "none")])
    def test_tile_gather(self, cuda, reso, finest, edge):
        pts, mask, _, toff, _ = tile_batch(13, reso=finest, edge=edge)
        rng = np.random.default_rng(1)
        plane = _bf(rng.normal(size=(2, reso, reso, 48)).astype(np.float32), cuda)
        xy = t(pts[..., :2], cuda)
        lvl_toff = t(toff[:, :: 4 ** ((finest.bit_length() - reso.bit_length()))], cuda)
        before = dict(runtime.LAUNCHES)
        got = gk.tile_gather(plane, xy, lvl_toff)
        want = gk.tile_gather_plain(plane, xy, lvl_toff)
        torch.cuda.synchronize()
        _launched("tile_gather_bf16", before)
        assert runtime.LAUNCHES["tile_gather"] == before["tile_gather"]
        assert got.dtype == BF and bf16_ulps(got, want) <= 1
        assert torch.equal(gk.tile_gather(plane, xy, lvl_toff), got)

    @pytest.mark.parametrize("kind", ["max", "mean"])
    @pytest.mark.parametrize("edge", ["none", "one_cell", "empty"])
    def test_tile_pool_and_backward(self, cuda, kind, edge):
        _, mask, cells, toff, vals = tile_batch(41, f=40, edge=edge)
        vals[~mask] = 0.0
        if edge == "none":  # ties
            vals = np.where(mask[..., None], np.random.default_rng(4).integers(0, 3, vals.shape),
                            vals).astype(np.float32)
        v, c, tt = _bf(vals, cuda), t(cells, cuda), t(toff, cuda)
        g = (torch.randn(vals.shape, generator=torch.Generator().manual_seed(5)).to(cuda, BF)
             * t(mask, cuda)[..., None]).contiguous()
        before = dict(runtime.LAUNCHES)
        out = tpk.tile_pool(v, c, tt, kind)
        dv = tpk.tile_pool_bwd(g, v, out, c, tt, kind)
        torch.cuda.synchronize()
        _launched("tile_pool_bf16", before)
        _launched("tile_pool_bwd_bf16", before)
        assert runtime.LAUNCHES["tile_pool"] == before["tile_pool"]
        want = tpk.tile_pool_plain(v, c, tt, kind)
        assert out.dtype == dv.dtype == BF and (out[t(~mask, cuda)] == 0).all()
        if kind == "max":
            assert torch.equal(out, want)
        else:
            assert bf16_ulps(out, want) <= 1
        assert bf16_ulps(dv, tpk.tile_pool_bwd_plain(g, v, out, c, tt, kind)) <= 1
        assert torch.equal(tpk.tile_pool(v, c, tt, kind), out)
        assert torch.equal(tpk.tile_pool_bwd(g, v, out, c, tt, kind), dv)

    @pytest.mark.parametrize("reso,finest,f,edge", [
        (64, 64, 32, "none"), (32, 64, 40, "empty"), (16, 64, 1024, "none"),
        (16, 64, 8, "one_cell")])
    def test_aligned_scatter_and_backward(self, cuda, reso, finest, f, edge):
        """K12 and K14 (>= 32^2), and K12's backward with the count cut to
        bf16 (a cell of ~800 rows at 16^2)."""
        _, _, cells, toff, vals = tile_batch(7, reso=finest, f=f, edge=edge)
        level = finest.bit_length() - reso.bit_length()
        v, c = _bf(vals, cuda), t(cells, cuda)
        lvl_toff = t(toff[:, :: 4 ** level], cuda)
        before = dict(runtime.LAUNCHES)
        got, counts = sk.aligned_scatter_mean_plane(v, c, lvl_toff, reso, finest,
                                                    with_counts=True)
        torch.cuda.synchronize()
        _launched("aligned_scatter_mean_plane_bf16", before)
        want, want_counts = sk.aligned_scatter_mean_plane_plain(v, c, lvl_toff, reso, finest,
                                                                with_counts=True)
        assert got.dtype == BF and torch.equal(counts, want_counts)
        assert bf16_ulps(got, want) <= 1
        assert torch.equal(sk.aligned_scatter_mean_plane(v, c, lvl_toff, reso, finest), got)
        if reso >= 32:
            got3 = sk.scatter_mean_plane_v3(v, c, t(toff, cuda), reso, finest)
            assert got3.dtype == BF and bf16_ulps(got3, want) <= 1
            assert torch.equal(sk.scatter_mean_plane_v3(v, c, t(toff, cuda), reso, finest),
                               got3)
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(6)).to(cuda, BF)
        before = dict(runtime.LAUNCHES)
        dv = sk.aligned_scatter_mean_plane_bwd(g, c, counts, reso, finest)
        torch.cuda.synchronize()
        _launched("aligned_scatter_mean_plane_bwd_bf16", before)
        _launched("pool_gather_bf16", before)
        assert runtime.LAUNCHES["pool_gather"] == before["pool_gather"]
        assert dv.dtype == BF
        assert torch.equal(dv, sk.aligned_scatter_mean_plane_bwd_plain(g, c, counts, reso,
                                                                       finest))
        assert torch.equal(sk.aligned_scatter_mean_plane_bwd(g, c, counts, reso, finest), dv)
        if edge == "one_cell":
            assert int(counts.max()) > 256

    @pytest.mark.parametrize("reso,f,one_cell", [(32, 8, False), (16, 4, True),
                                                 (64, 96, False)])
    def test_sorted_scatter_mean(self, cuda, reso, f, one_cell):
        vals, cells, offs = sorted_batch(3, reso=reso, f=f, one_cell=one_cell)
        v, c, o = _bf(vals, cuda), t(cells, cuda), t(offs, cuda)
        before = dict(runtime.LAUNCHES)
        plane = sk.scatter_mean_plane(v, c, o, reso)
        vec = sk.scatter_mean(v, c, o, reso)
        torch.cuda.synchronize()
        _launched("scatter_mean_plane_bf16", before)
        _launched("scatter_mean_bf16", before)
        assert plane.dtype == vec.dtype == BF
        assert bf16_ulps(plane, sk.scatter_mean_plane_plain(v, c, o, reso)) <= 1
        assert bf16_ulps(vec, sk.scatter_mean_plain(v, c, o, reso)) <= 1
        assert torch.equal(sk.scatter_mean(v, c, o, reso), vec)

    @pytest.mark.parametrize("reso,finest,edge", [(64, 64, "empty"), (32, 64, "border"),
                                                  (32, 32, "one_cell")])
    def test_tile_gather_bwd(self, cuda, reso, finest, edge):
        pts, mask, cells, _, _ = tile_batch(5, n=800, reso=finest, f=24, edge=edge)
        g = torch.randn(*mask.shape, 24, generator=torch.Generator().manual_seed(3))
        args = (g.to(cuda, BF), t(pts[..., :2].copy(), cuda), t(cells, cuda), t(mask, cuda),
                reso, finest)
        before = dict(runtime.LAUNCHES)
        got = gk.tile_gather_bwd(*args)
        torch.cuda.synchronize()
        _launched("tile_gather_bwd_bf16", before)
        _launched("level_d_plane_bf16", before)
        assert got.dtype == BF and bf16_ulps(got, lk.level_d_plane_plain(*args)) <= 1
        assert torch.equal(gk.tile_gather_bwd(*args), got)

    @pytest.mark.parametrize("impl,reso", [("cumsum", 256), ("cumsum", 32), ("fused", 16)])
    def test_sorted_sample_bwd(self, cuda, impl, reso):
        """The f32 sample of a bf16 plane; its backward from the f32
        cotangent on K5's d_plane pass from f32 into bf16
        (``level_d_plane_wide_bf16``)."""
        import chip_smoke as cs

        pts, mask, apts, amask, acells, _ = cs.flagship_batch(2, b=2, n=4000, tile_cells=256)
        if impl == "cumsum":
            apts, amask, acells, _ = cs.sorted_layout(pts, mask)
        xy, m, c = t(apts[..., :2].copy(), cuda), t(amask, cuda), t(acells, cuda)
        gen = torch.Generator().manual_seed(5)
        plane = torch.randn(2, reso, reso, 40, generator=gen).to(cuda, BF).requires_grad_()
        g = torch.randn(*amask.shape, 40, generator=gen).to(cuda)
        before = dict(runtime.LAUNCHES)
        out = fused.sorted_sample(plane, xy, m, c, 256)
        got, again = (torch.autograd.grad(fused.sorted_sample(plane, xy, m, c, 256), plane,
                                          g)[0] for _ in range(2))
        torch.cuda.synchronize()
        _launched("level_d_plane_wide_bf16", before, 2)
        assert runtime.LAUNCHES["level_d_plane"] == before["level_d_plane"]
        assert out.dtype == torch.float32 and got.dtype == BF and torch.equal(got, again)
        want = lk.level_d_plane_plain(g, xy, c, m, reso, 256, BF)
        assert bf16_ulps(got, want) <= 1

    @pytest.mark.parametrize("impl", ["fused", "cumsum"])
    def test_bf16_step_launches_and_repeats(self, cuda, impl):
        """The flagship in bf16 at full width on 2 patches: one mini-step
        launches what ``chip_smoke.SORTED_TRAIN_BF16_LAUNCHES`` (``cumsum``:
        ``CUMSUM_TRAIN_BF16_LAUNCHES``) counts, its loss within 0.15 x
        z_scale of the f32 step's, and a second step from the same weights
        gives the same gradients, bit for bit."""
        import chip_smoke as cs
        from tomosar2height_tpu_torch.config import sorted_config
        from tomosar2height_tpu_torch.models import build_model, init_weights
        from tomosar2height_tpu_torch.ops.cuda.conv_kernel import fp32_convs
        from tomosar2height_tpu_torch.train import Trainer

        cfg = sorted_config(impl)
        model = init_weights(build_model(cfg, "cuda"), torch.Generator().manual_seed(0))
        cfg16 = sorted_config(impl)
        cfg16["model"]["dtype"] = "bfloat16"
        model16 = build_model(cfg16, "cuda")
        model16.load_state_dict(model.state_dict())
        pts, mask, apts, amask, _, toff = cs.flagship_batch(1, b=2, tile_cells=256)
        if impl == "cumsum":
            apts, amask, _, toff = cs.sorted_layout(pts, mask)
        side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
        rng = np.random.default_rng(2)
        batch = {"points": apts, "point_mask": amask, "cell_offsets": toff,
                 "dsm": rng.uniform(0, 40, (2, side, side)).astype(np.float32),
                 "patch_valid": np.ones(2, bool)}

        def step(m):
            trainer = Trainer(m, cfg["training"])
            dev = trainer.prepare_batch(batch)
            runtime.reset_launches()
            with fp32_convs(deterministic=True):
                loss, _ = trainer.loss(dev)
                grads = torch.autograd.grad(loss, trainer.params)
            torch.cuda.synchronize()
            return float(loss), grads, {k: v for k, v in runtime.LAUNCHES.items() if v}

        loss, grads, launched = step(model16)
        assert launched == (cs.SORTED_TRAIN_BF16_LAUNCHES if impl == "fused"
                            else cs.CUMSUM_TRAIN_BF16_LAUNCHES)
        _, grads2, _ = step(model16)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
        ref, _, _ = step(model)
        z = cfg["dataset"]["normalize"]["z_bound"]
        assert abs(loss - ref) <= 0.15 * (z[1] - z[0]), (loss, ref)


@pytest.mark.cuda
class TestWgmmaBf16Kernels:
    """The two bf16 kernels on the TMA and wgmma: K5's weight sums
    (``csrc/reduce_bf16.cu``) at odd M, at Ka and Nb of 32, 64 and 1024,
    with and without the bias, within one bf16 ulp of their bf16 plain
    version; K8 in bf16 (``csrc/conv_bf16.cu``) at 16^2, 32^2 and 512^2, Cin
    3 (the flat-K route), 32 (32-channel boxes) and 64, held as
    ``_bf16_held``; each bit-equal on a second launch, the route's launches
    counted apart."""

    @pytest.mark.parametrize("m,ka,nb,bias", [
        (777, 32, 64, True), (777, 1024, 32, False), (50001, 64, 1024, True),
        (50001, 1024, 1024, True), (163843, 32, 32, True), (163843, 1024, 64, False),
        (4097, 64, 64, False), (12345, 1024, 1024, False)])
    def test_reduce_matches_plain(self, cuda, m, ka, nb, bias):
        rng = np.random.default_rng(m + ka + nb)
        a = _bf(rng.normal(size=(m, ka)).astype(np.float32), cuda)
        b = _bf(rng.normal(size=(m, nb)).astype(np.float32), cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.level_bwd_reduce(a, b, bias)
        want = lk.level_bwd_reduce_plain(a, b, bias)
        torch.cuda.synchronize()
        _launched("level_bwd_reduce_bf16", before)
        assert (got[1] is None) == (not bias)
        for x, y in zip(got, want):
            if y is not None:
                ulp = 2.0 ** (float(torch.floor(torch.log2(y.float().abs().max()))) - 7)
                assert x.dtype == BF and x.shape == y.shape
                assert float((x.float() - y.float()).abs().max()) <= ulp

    def test_reduce_is_bit_equal_run_to_run(self, cuda):
        rng = np.random.default_rng(5)
        a = _bf(rng.normal(size=(20011, 512)).astype(np.float32), cuda)
        b = _bf(rng.normal(size=(20011, 1024)).astype(np.float32), cuda)
        first = lk.level_bwd_reduce(a, b, True)
        again = lk.level_bwd_reduce(a, b, True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))

    def test_reduce_plan_is_the_kernels(self, cuda):
        from tomosar2height_tpu_torch.ops.cuda import tile_plan

        lib = runtime.library()
        for ka in (8, 32, 64, 72, 128, 136, 256, 512, 1024):
            for nb in (8, 32, 64, 72, 128, 200, 256, 512, 1024):
                nx, ny = tile_plan.reduce_grid(ka, nb)
                assert lib.t2h_level_bwd_reduce_tiles_bf16(ka, nb) == nx * ny

    @pytest.mark.parametrize("relu", [True, False])
    @pytest.mark.parametrize("b,h,cin,cout", [
        (2, 16, 3, 32), (2, 16, 32, 64), (2, 16, 64, 1024), (2, 32, 64, 128),
        (2, 32, 32, 256), (1, 512, 64, 32), (1, 512, 32, 64), (1, 512, 3, 32)])
    def test_conv3x3_matches_plain(self, cuda, b, h, cin, cout, relu):
        rng = np.random.default_rng(h + cin + cout)
        x = t(rng.normal(0, 1, (b, h, h, cin)).astype(np.float32), cuda).to(BF)
        k, bias = (t(a, cuda) for a in conv_weights(rng, cin, cout))
        k = k.to(BF)
        before = dict(runtime.LAUNCHES)
        got = ck.conv3x3(x, k, bias, relu)
        torch.cuda.synchronize()
        route = "flat" if cin == 3 else "wgmma"
        _launched("conv3x3_bf16", before)
        _launched(f"conv3x3_bf16_{route}", before)
        want = ck.conv3x3_plain(x, k, bias, relu)
        assert got.dtype == BF and torch.equal(ck.conv3x3(x, k, bias, relu), got)
        _bf16_held(got, want, ck.conv3x3_plain(x.double(), k.double(), bias.double(), relu))

    @pytest.mark.parametrize("h,w,cin,cout", [(9, 11, 40, 72), (20, 136, 8, 200)])
    def test_conv3x3_ragged_rectangles(self, cuda, h, w, cin, cout):
        """Rectangles past the image (W 11: 11 x 11 pixels a block, H 9; W
        136: a second 128-pixel rectangle of 8), Cin and Cout past the
        channel boxes: the TMA's zero fill and dropped stores."""
        rng = np.random.default_rng(w)
        x = t(rng.normal(0, 1, (3, h, w, cin)).astype(np.float32), cuda).to(BF)
        k, bias = (t(a, cuda) for a in conv_weights(rng, cin, cout))
        k = k.to(BF)
        before = dict(runtime.LAUNCHES)
        got = ck.conv3x3(x, k, bias, True)
        torch.cuda.synchronize()
        _launched("conv3x3_bf16_wgmma", before)
        _bf16_held(got, ck.conv3x3_plain(x, k, bias, True),
                   ck.conv3x3_plain(x.double(), k.double(), bias.double(), True))


def _level_bf16_args(inp, level_reso, reso, device):
    pts, mask, cells, _, plane, c_last, weights = inp
    return (_bf(plane, device), _bf(c_last, device), tuple(_bf(w, device) for w in weights),
            t(pts[..., :2], device), t(cells, device), t(mask, device), level_reso, reso)


# (H = W, Cin, C, pool) of K7's 20 pairs (chip_smoke.ALTO_PAIRS + IMAGE_PAIRS)
_PAIRS = [(256, 32, 32, False), (256, 32, 64, False), (128, 64, 128, False),
          (64, 128, 256, False), (32, 256, 512, False), (64, 512, 256, False),
          (128, 256, 128, False), (256, 128, 64, False), (256, 64, 32, False),
          (512, 3, 32, True), (256, 32, 64, True), (128, 64, 128, True),
          (64, 128, 256, True), (32, 256, 512, True), (16, 512, 1024, False),
          (32, 1024, 512, False), (64, 512, 256, False), (128, 256, 128, False),
          (256, 128, 64, False), (512, 64, 32, False)]


@pytest.mark.cuda
class TestWgmmaLevelAndPair:
    """K4 in bf16 (``csrc/level_bf16.cu``) and both convs of K7 in bf16
    (``csrc/conv_bf16.cu``, the pool in the second's epilogue) on the TMA
    and wgmma: K4 at every width of the flagship's levels
    (``chip_smoke.LEVEL_SHAPES``) and at Fl = 1024, on rows that end inside
    a block, with a patch of padding rows only, under the JAX package's bf16
    rule (``bf16_level_held``); K7 at every pair shape of a fusion forward at
    batch 1-2, pooled and not, held as ``_bf16_held``, its convs counted by
    route (the Cin = 3 conv on the flat-K path). Each bit-equal on a second
    launch."""

    @pytest.mark.parametrize("level_reso,f,fl", [
        (256, 32, 32), (256, 64, 32), (128, 128, 64), (64, 256, 128), (32, 512, 256),
        (64, 256, 512), (128, 128, 256), (256, 64, 128), (32, 512, 1024), (64, 256, 1024)])
    def test_level_matches_plain(self, cuda, level_reso, f, fl):
        inp = level_inputs(256, level_reso, f, fl, seed=31, b=3, n=1500, empty_last=True)
        cut = inp[1].shape[1] - 37  # rows that end inside a 128- or 64-row block
        inp = tuple(x[:, :cut] if i in (0, 1, 2, 5) else x for i, x in enumerate(inp))
        args = _level_bf16_args(inp, level_reso, 256, cuda)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level(*args)
        want = lk.fused_level_plain(*args)
        ref = lk.fused_level_plain(args[0].float(), args[1].float(),
                                   tuple(w.float() for w in args[2]), *args[3:])
        torch.cuda.synchronize()
        _launched("fused_level_bf16", before)
        assert got[1].shape == (3, cut, f)
        for i in (0, 1):
            bf16_level_held(got[i], want[i], ref[i])
        assert torch.equal(got[2], want[2])
        assert (got[1][-1] == 0).all() and (got[1][~args[5]] == 0).all()
        assert all(torch.equal(a, b) for a, b in zip(lk.fused_level(*args), got))

    @pytest.mark.parametrize("f,fl", [(8, 4), (20, 12), (24, 600), (200, 40)])
    def test_level_pads_ragged_widths(self, cuda, f, fl):
        """F or Fl not a multiple of 8 (zero columns added for the TMA, and
        c_out's sliced off), F 24 (a k16 step half past F) and F 200 (a W_in
        stage cut short)."""
        inp = level_inputs(64, 32, f, fl, seed=33, b=2, n=600)
        args = _level_bf16_args(inp, 32, 64, cuda)
        got = lk.fused_level(*args)
        want = lk.fused_level_plain(*args)
        ref = lk.fused_level_plain(args[0].float(), args[1].float(),
                                   tuple(w.float() for w in args[2]), *args[3:])
        torch.cuda.synchronize()
        assert got[1].shape == want[1].shape and got[1].is_contiguous()
        for i in (0, 1):
            bf16_level_held(got[i], want[i], ref[i])

    def test_level_unaligned_operands_are_copied(self, cuda):
        inp = level_inputs(64, 32, 64, 64, seed=35, b=2, n=600)
        args = list(_level_bf16_args(inp, 32, 64, cuda))
        c = args[1]
        shifted = torch.empty(c.numel() + 1, device=cuda, dtype=BF)[1:].view(c.shape)
        shifted.copy_(c)
        assert shifted.data_ptr() % 16 and shifted.is_contiguous()
        got = lk.fused_level(args[0], shifted, *args[2:])
        want = lk.fused_level(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    @pytest.mark.parametrize("pool", [False, True])
    @pytest.mark.parametrize("h,cin,c,model_pool", _PAIRS)
    def test_conv_pair_matches_plain(self, cuda, h, cin, c, model_pool, pool):
        rng = np.random.default_rng(h + cin + c)
        b = 1 if h >= 256 else 2
        x = t(rng.normal(0, 1, (b, h, h, cin)).astype(np.float32), cuda).to(BF)
        args = (x, *_bf16_weights(rng, cin, c, cuda), *_bf16_weights(rng, c, c, cuda))
        before = dict(runtime.LAUNCHES)
        got = cpk.conv_pair(*args, pool)
        torch.cuda.synchronize()
        _launched("conv_pair_bf16", before)
        _launched("conv_pair_bf16_wgmma", before, 1 if cin == 3 else 2)
        _launched("conv_pair_bf16_flat", before, 1 if cin == 3 else 0)
        want = cpk.conv_pair_plain(*args, pool)
        ref = cpk.conv_pair_plain(*(a.double() for a in args), pool)
        again = cpk.conv_pair(*args, pool)
        for i in (0, 1) if pool else (0,):
            assert got[i].dtype == BF and torch.equal(again[i], got[i])
            _bf16_held(got[i], want[i], ref[i])
        assert (got[1] is None) == (not pool)


@pytest.mark.cuda
class TestWgmmaDecoder:
    """K6 in bf16 (``t2h_conv_decoder_bf16``, ``csrc/conv_bf16.cu``): its
    three convs on the TMA-fed wgmma pipeline, the head in the third's
    epilogue, at the model's shape (``chip_smoke.DECODER`` at batch 2) and
    at small odd ones (rectangles past the image, x3 narrower than its
    64-channel block, w4 in two passes of columns); held as ``_bf16_held``
    to the plain version, bit-equal on a second launch, its convs counted by
    route (``tile_plan.decoder_plan``)."""

    @pytest.mark.parametrize("b,h,w,c0,c1,c2,c3,co", [
        (2, 512, 512, 32, 64, 128, 64, 1), (3, 13, 21, 8, 16, 24, 16, 3),
        (1, 9, 140, 16, 8, 32, 40, 25)])
    def test_matches_plain(self, cuda, b, h, w, c0, c1, c2, c3, co):
        rng = np.random.default_rng(h + w + c3)
        x = t(rng.normal(0, 1, (b, h, w, c0)).astype(np.float32), cuda).to(BF)
        args = (x, *_bf16_weights(rng, c0, c1, cuda), *_bf16_weights(rng, c1, c2, cuda),
                *_bf16_weights(rng, c2, c3, cuda),
                *_bf16_weights(rng, c0 + c1 + c2 + c3, co, cuda, k=1))
        before = dict(runtime.LAUNCHES)
        got = dk.conv_decoder(*args)
        torch.cuda.synchronize()
        _launched("conv_decoder_bf16", before)
        _launched("conv_decoder_bf16_wgmma", before, 3)
        _launched("conv_decoder_bf16_flat", before, 0)
        assert got.dtype == torch.float32 and got.shape == (b, h, w, co)
        assert torch.equal(dk.conv_decoder(*args), got)
        want = dk.conv_decoder_plain(*args)
        _bf16_held(got, want, dk.conv_decoder_plain(*(a.double() for a in args)))

    def test_unaligned_input_takes_the_conv_core(self, cuda):
        """x at an address that is not 16-byte aligned: conv1 and the head
        take the conv core; the result is the aligned call's within the
        rule (another order of the head's sums)."""
        rng = np.random.default_rng(41)
        x = t(rng.normal(0, 1, (2, 16, 24, 16)).astype(np.float32), cuda).to(BF)
        shifted = torch.empty(x.numel() + 1, device=cuda, dtype=BF)[1:].view(x.shape)
        shifted.copy_(x)
        ws = (*_bf16_weights(rng, 16, 32, cuda), *_bf16_weights(rng, 32, 64, cuda),
              *_bf16_weights(rng, 64, 64, cuda), *_bf16_weights(rng, 176, 1, cuda, k=1))
        before = dict(runtime.LAUNCHES)
        got = dk.conv_decoder(shifted, *ws)
        torch.cuda.synchronize()
        _launched("conv_decoder_bf16_wgmma", before, 1)
        _launched("conv_decoder_bf16_flat", before, 2)
        _bf16_held(got, dk.conv_decoder_plain(x, *ws),
                   dk.conv_decoder_plain(x.double(), *(a.double() for a in ws)))


@pytest.mark.cuda
class TestUnsortedOrder:
    """The unsorted point path's plain ops (``ops/scatter.py``: the segment
    sums, means and counts, ``gather_cells``' backward; ``ops/sampling.py``:
    ``grid_sample_2d``'s backward and the adjoint) at the flagship's sizes
    (batch 8, 16384 rows, 256^2 cells), in float32 and bf16: each run twice
    on the card, bit-equal, and within 1e-5 (bf16: 2^-5) of the scale of the
    CPU's row-order result; the deterministic mode as it was after each."""

    @staticmethod
    def _inputs(dtype, device, c=32, reso=256):
        rng = np.random.default_rng(43)
        b, n = 8, 16384
        xy = rng.uniform(0, 1, (b, n, 2)).astype(np.float32)
        xy[:, : n // 4] = rng.uniform(0.40, 0.41, (b, n // 4, 2))  # crowded cells
        vals = t(rng.normal(0, 1, (b, n, c)).astype(np.float32), device).to(dtype)
        mask = t(rng.random((b, n)) > 0.1, device)
        plane = t(rng.normal(0, 1, (b, reso, reso, c)).astype(np.float32), device).to(dtype)
        return t(xy, device), vals, mask, plane

    @pytest.mark.parametrize("dtype", [torch.float32, BF])
    def test_ops_bit_equal_run_to_run(self, cuda, dtype):
        from tomosar2height_tpu_torch.ops import sampling, scatter

        xy, vals, mask, plane = self._inputs(dtype, cuda)
        reso = plane.shape[1]
        mode = torch.are_deterministic_algorithms_enabled()

        def run(v, p, xy_):
            v, p = v.clone().requires_grad_(), p.clone().requires_grad_()
            i = scatter.cell_index(xy_, reso)
            m = mask.to(v.device)
            mean = scatter.segment_mean(v, i, reso * reso, m)
            pooled = scatter.pool_local_max(v, i, reso, m)
            sample = sampling.grid_sample_2d(p, xy_, m)
            counts = scatter.segment_counts(i, reso * reso, m)
            keep = m[..., None].float()  # the masked rows reach nothing, as in the model
            loss = (mean.float().sum() + (pooled.float() * keep * 1.5).sum()
                    + (sample.float() * v.float() * keep).sum())
            dv, dp = torch.autograd.grad(loss, (v, p))
            adj = sampling.grid_sample_2d_adjoint(v.float(), xy_, reso, reso)
            return mean, pooled, sample, counts, dv, dp, adj

        first, again = run(vals, plane, xy), run(vals, plane, xy)
        torch.cuda.synchronize()
        assert torch.are_deterministic_algorithms_enabled() == mode
        for a, g in zip(first, again):
            assert torch.equal(a, g)
        host = run(vals.cpu(), plane.cpu(), xy.cpu())
        for a, h in zip(first, host):
            # bf16: sums of up to ~500 rows, each add rounded to bf16
            scale = max(1.0, float(h.double().abs().max()))
            tol = (2.0 ** -5 if dtype == BF else 1e-5) * scale
            assert float((a.cpu().double() - h.double()).abs().max()) <= tol


@pytest.mark.cuda
class TestWgmmaRowPassAndDPlaneTiles:
    """K5's bf16 row pass on the TMA and wgmma (``csrc/level_bwd_bf16.cu``,
    its plan ``tile_plan.level_bwd_plan``) at every width class, Fl up to
    1024, rows that end inside a block, a patch of padding rows only, valid
    rows with no cell (-1) and ragged widths (padded to multiples of 8),
    under the JAX package's bf16 rule (``bf16_level_held``) on the rows off
    the ReLU kink; and K5's d_plane pass as a pixel-tile gather
    (``d_plane_tiles``) in its three instances at R = 1, 2, 32 and 256, fr =
    R, and ragged F (the value-at-a-time path), the f32 instance at K5's
    tolerance of the float64 transpose, the bf16 ones within one bf16 ulp of
    their plain versions. Each counted and bit-equal on a second launch."""

    @pytest.mark.parametrize("level_reso,f,fl", [
        (256, 32, 32), (256, 64, 128), (128, 128, 64), (64, 256, 128), (64, 256, 512),
        (32, 512, 256), (32, 512, 1024), (128, 128, 1024), (64, 20, 12), (32, 8, 8)])
    def test_bf16_rows_match_plain(self, cuda, level_reso, f, fl):
        inp = level_inputs(256, level_reso, f, fl, seed=41, b=3, n=1500, empty_last=True)
        cut = inp[1].shape[1] - 37  # rows that end inside a 128- or 64-row block
        pts, mask, cells, toff, plane, c_last, weights = (
            x[:, :cut] if i in (0, 1, 2, 5) else x for i, x in enumerate(inp))
        cells = cells.copy()
        cells[0, 3:300:7] = -1  # valid rows with no cell: d_o = g_c there
        fwd = list(_level_bf16_args((pts, mask, cells, toff, plane, c_last, weights),
                                    level_reso, 256, cuda))
        pre = lk.mm(lk.level_sample(fwd[0], fwd[3]), fwd[2][0]) + fwd[2][1]
        m5 = fwd[5] & ~(pre.float().abs() < 2e-5).any(-1)
        fwd[5] = m5
        counts = lk.fused_level_plain(*fwd)[2]
        g_p, g_c = (_bf(x, cuda) for x in level_cotangents(inp, seed=9))
        args = (*fwd[:6], counts, g_p, g_c[:, :cut].contiguous(), level_reso, 256)
        before = dict(runtime.LAUNCHES)
        got = lk.fused_level_bwd_rows(*args)
        want = lk.fused_level_bwd_rows_plain(*args)
        up = tuple(tuple(w.float() for w in a) if isinstance(a, tuple) else
                   a.float() if torch.is_tensor(a) and a.dtype == BF else a for a in args)
        ref = lk.fused_level_bwd_rows_plain(*up)
        torch.cuda.synchronize()
        _launched("fused_level_bwd_bf16", before)
        assert got[0].shape == (3, cut, fl) and got[2].shape == (3 * cut, 2 * f)
        assert all(x.is_contiguous() for x in got)
        v = m5.reshape(-1)
        bf16_level_held(got[0], want[0], ref[0])
        for a, b, r in zip(got[1:], want[1:], ref[1:]):
            bf16_level_held(a[v], b[v], r[v])
        assert (got[0][-1] == 0).all()  # the patch of padding rows
        assert all((x.reshape(3, cut, -1)[-1] == 0).all() for x in got[1:])
        pad = ~t(mask, cuda).reshape(-1)
        assert all((x[pad] == 0).all() for x in (got[3], got[4], got[5]))  # d_o, d_h, d_s
        again = lk.fused_level_bwd_rows(*args)
        assert all(torch.equal(a, b) for a, b in zip(again, got))

    def test_bf16_rows_plan_matches_the_c_side(self, cuda):
        """The wrapper holds tile_plan.level_bwd_plan to the C side's at
        every width class (``t2h_level_bwd_plan_bf16``)."""
        from tomosar2height_tpu_torch.ops.cuda import tile_plan as tp
        for f, fl in ((32, 32), (64, 128), (128, 1024), (256, 512), (512, 256), (512, 1024)):
            assert lk._bwd_plan(f, fl) == tp.level_bwd_plan(f, fl)

    @pytest.mark.parametrize("reso,level_reso,f", [
        (256, 1, 64), (256, 2, 24), (256, 32, 512), (256, 256, 32), (256, 256, 9),
        (32, 32, 64), (64, 64, 100)])
    @pytest.mark.parametrize("kind", ["f32", "bf16", "wide"])
    def test_d_plane_tiles_match_plain(self, cuda, reso, level_reso, f, kind):
        inp = level_inputs(reso, level_reso, 8, 4, seed=53 + f, b=3, n=2500, empty_last=True)
        pts, mask, cells = inp[:3]
        rng = np.random.default_rng(level_reso + f)
        d_s = t(rng.normal(size=mask.shape + (f,)).astype(np.float32), cuda)
        if kind == "bf16":
            d_s = d_s.to(BF)
        out = BF if kind == "wide" else None
        xy, c, m = t(pts[..., :2], cuda), t(cells, cuda), t(mask, cuda)
        name = {"f32": "level_d_plane", "bf16": "level_d_plane_bf16",
                "wide": "level_d_plane_wide_bf16"}[kind]
        before = dict(runtime.LAUNCHES)
        got = lk.level_d_plane(d_s, xy, c, m, level_reso, reso, out)
        torch.cuda.synchronize()
        _launched(name, before)
        assert got.shape == (3, level_reso, level_reso, f) and (got[-1] == 0).all()
        if kind == "f32":
            want = lk.level_d_plane_plain(d_s.double(), xy.double(), c, m, level_reso, reso)
            torch.testing.assert_close(got.double(), want, atol=2e-5, rtol=2e-4)
        else:
            want = lk.level_d_plane_plain(d_s, xy, c, m, level_reso, reso, out)
            assert got.dtype == BF and bf16_ulps(got, want) <= 1
        assert torch.equal(lk.level_d_plane(d_s, xy, c, m, level_reso, reso, out), got)
        from tomosar2height_tpu_torch.ops.cuda import tile_plan as tp
        assert lk._d_plane_plan(level_reso, f, reso, d_s.element_size()) == tp.d_plane_plan(
            level_reso, f, reso, d_s.element_size())
