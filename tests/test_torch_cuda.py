"""The PyTorch port's CUDA kernels K1-K8 against their plain versions, on the
card, forward and backward (K6-K8 backward: the plain composition's). Marked ``cuda``: they skip where no CUDA card is
present (the kernels have no CPU mode). This file imports no JAX, so it runs on a machine without
it; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

It also holds the numpy input builders that ``test_torch_pool2*.py`` and
``test_torch_level*.py`` feed to the JAX package. Tolerance 1e-5 (rtol and
atol): float atomics sum in another order than the plain versions. K5's
d_plane and d_c_last: 2e-5 abs + 2e-4 rel (tests/test_fused_level_bwd.py);
its weight gradients are sums over every row, so 3e-4 * max|ref| abs + 3e-4
rel. The conv kernels K6-K8: 1e-5 abs + rel (fp32 FMA in another order than
cuDNN's full-fp32 convolutions).
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
from tomosar2height_tpu_torch.ops.cuda import runtime
from tomosar2height_tpu_torch.ops.sorted_scatter import (
    aligned_bucket_size,
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
        (64, 64, 8, 4), (64, 32, 16, 16), (32, 32, 8, 8), (256, 32, 512, 256)])
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
