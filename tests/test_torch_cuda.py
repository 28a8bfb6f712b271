"""The PyTorch port's CUDA kernels K1-K14 against their plain versions, on the
card, forward and backward (K6-K12 backward: the plain composition's). Marked
``cuda``: they skip where no CUDA card is present (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine without it; there,
skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

It also holds the numpy input functions that ``test_torch_pool2*.py``,
``test_torch_level*.py`` and ``test_torch_tile_kernels.py`` feed to the JAX
package. Tolerance 1e-5 (rtol and atol): float atomics sum in another order
than the plain versions. K5's d_plane and d_c_last: 2e-5 abs + 2e-4 rel
(tests/test_fused_level_bwd.py); its weight gradients are sums over every
row, so 3e-4 * max|ref| abs + 3e-4 rel. The conv kernels K6-K8: 1e-5 abs +
rel (fp32 FMA in another order than cuDNN's full-fp32 convolutions). The
backwards of K9/K10/K12 are the plain composition's autograd: 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
    aligned_bucket_size,
    host_morton_bucket,
    host_morton_bucket_aligned,
)

RESO = 64
TOL = dict(rtol=1e-5, atol=1e-5)


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
        assert runtime.LAUNCHES["pool_reduce"] == before["pool_reduce"] + 1
        assert runtime.LAUNCHES["pool_gather"] == before["pool_gather"] + 1

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
        got = pk.pool_reduce(v, c, m, RESO * RESO, "sum")
        want = pk.pool_reduce_plain(v, c, m, RESO * RESO, "sum")
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
        assert runtime.LAUNCHES["pool_reduce"] == before["pool_reduce"] + 1
        assert runtime.LAUNCHES["pool_gather"] == before["pool_gather"] + 1
        assert runtime.LAUNCHES["pool2_bwd"] == before["pool2_bwd"] + 1

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

    def test_wrong_dtype_raises(self, cuda):
        _, mask, cells, _, vals = aligned_batch(0)
        with pytest.raises(TypeError):
            pk.pool2(t(vals, cuda).double(), t(cells, cuda), t(mask, cuda), RESO, "max")


@pytest.mark.cuda
class TestLevelKernel:
    @pytest.mark.parametrize("reso,level_reso,f,fl", [
        (64, 64, 8, 4), (64, 32, 16, 16), (32, 32, 8, 8), (256, 32, 512, 256),
        (256, 32, 512, 1024), (64, 32, 64, 600)])
    def test_matches_plain(self, cuda, reso, level_reso, f, fl):
        inp = level_inputs(reso, level_reso, f, fl, seed=7, empty_last=True)
        n0 = runtime.LAUNCHES["fused_level"]
        got = run_level(inp, reso, level_reso, device=cuda)
        want = run_level(inp, reso, level_reso, fn=lk.fused_level_plain, device=cuda)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_level"] == n0 + 1
        torch.testing.assert_close(got[0], want[0], **TOL)
        torch.testing.assert_close(got[1], want[1], **TOL)
        assert torch.equal(got[2], want[2])
        assert (got[1][-1] == 0).all()  # the empty patch


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
                s = fused.tile_gather(p, xy, m, tt, RESO)
                q = fused.tile_pool(v, c, tt, m, RESO, "max")
                o = fused.tile_scatter_mean(v, c, tt, RESO, RESO)
            else:
                s = fused._gather_plain(p, xy, m, tt)
                q = fused._masked(m, tpk.tile_pool_plain(v, c, tt, "max"))
                o = sk.aligned_scatter_mean_plane_plain(v, c, tt, RESO, RESO)
            ((s ** 2).sum() + (q * v).sum() + (o ** 2).sum()).backward()
            return p.grad, v.grad

        before = dict(runtime.LAUNCHES)
        got = grads(True)
        want = grads(False)
        torch.cuda.synchronize()
        for name in ("tile_gather", "tile_pool", "aligned_scatter_mean_plane"):
            _launched(name, before)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
