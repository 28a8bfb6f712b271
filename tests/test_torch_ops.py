"""The PyTorch port's plain ops against the JAX package's, on the same numpy
inputs. Tolerance 1e-5 (rtol and atol) for float ops; exact equality for max
reductions and for the Morton and aligned-layout helpers."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.ops import resize as jresize  # noqa: E402
from tomosar2height_tpu.ops import sampling as jsampling  # noqa: E402
from tomosar2height_tpu.ops import scatter as jscatter  # noqa: E402
from tomosar2height_tpu.ops import sorted_scatter as jsorted  # noqa: E402
from tomosar2height_tpu_torch.ops import resize, sampling, scatter  # noqa: E402
from tomosar2height_tpu_torch.ops import sorted_scatter as tsorted  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture()
def points(rng):
    b, n, reso, c = 2, 600, 16, 5
    pts = rng.uniform(0.0, 1.0, (b, n, 3)).astype(np.float32)
    pts[0, :4, :2] = [[0.0, 0.0], [1.0, 1.0], [0.999999, 0.0], [0.5, 1.0]]  # edges
    mask = rng.random((b, n)) > 0.2
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    vals[1, 10:14] = vals[1, 10]  # ties
    return pts, mask, vals, reso


class TestSegmentOps:
    def test_cell_index(self, points):
        pts, _, _, reso = points
        np.testing.assert_array_equal(
            scatter.cell_index(_t(pts[..., :2]), reso).numpy(),
            np.asarray(jscatter.cell_index(jnp.asarray(pts[..., :2]), reso)))

    def test_counts_mean_max(self, points):
        pts, mask, vals, reso = points
        idx = np.asarray(jscatter.cell_index(jnp.asarray(pts[..., :2]), reso))
        s = reso * reso
        for m in (None, mask):
            jm = None if m is None else jnp.asarray(m)
            tm = None if m is None else _t(m)
            np.testing.assert_array_equal(
                scatter.segment_counts(_t(idx), s, tm).numpy(),
                np.asarray(jscatter.segment_counts(jnp.asarray(idx), s, jm)))
            np.testing.assert_allclose(
                scatter.segment_mean(_t(vals), _t(idx), s, tm).numpy(),
                np.asarray(jscatter.segment_mean(jnp.asarray(vals), jnp.asarray(idx), s, jm)),
                **TOL)
            got = scatter.segment_max(_t(vals), _t(idx), s, tm).numpy()
            want = np.asarray(jscatter.segment_max(jnp.asarray(vals), jnp.asarray(idx), s, jm))
            np.testing.assert_array_equal(got, want)

    def test_empty_and_masked_cells_are_zero(self):
        vals = torch.tensor([[[5.0], [-3.0], [7.0]]])
        idx = torch.tensor([[0, 0, 2]])
        mask = torch.tensor([[True, True, False]])
        np.testing.assert_array_equal(
            scatter.segment_max(vals, idx, 4, mask).numpy().ravel(), [5.0, 0, 0, 0])
        np.testing.assert_array_equal(
            scatter.segment_mean(vals, idx, 4, mask).numpy().ravel(), [1.0, 0, 0, 0])

    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_pool_local(self, points, kind):
        pts, mask, vals, reso = points
        idx = np.asarray(jscatter.cell_index(jnp.asarray(pts[..., :2]), reso))
        tfn = scatter.pool_local_max if kind == "max" else scatter.pool_local_mean
        jfn = jscatter.pool_local_max if kind == "max" else jscatter.pool_local_mean
        got = tfn(_t(vals), _t(idx), reso, _t(mask)).numpy()
        want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(idx), reso, jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, **TOL)


class TestSamplingResize:
    @pytest.mark.parametrize("hw", [(9, 13), (32, 32)])
    def test_grid_sample(self, rng, hw):
        plane = rng.normal(size=(2,) + hw + (4,)).astype(np.float32)
        xy = rng.uniform(-0.1, 1.1, (2, 300, 2)).astype(np.float32)
        xy[0, :4] = [[0, 0], [1, 1], [1, 0], [0, 1]]  # corners: +1 neighbour weight 0
        got = sampling.grid_sample_2d(_t(plane), _t(xy)).numpy()
        want = np.asarray(jsampling.grid_sample_2d(jnp.asarray(plane), jnp.asarray(xy)))
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("hw", [(16, 16), (32, 48), (7, 5)])
    def test_resize_bilinear(self, rng, hw):
        x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
        got = resize.resize_bilinear(_t(x), hw).numpy()
        want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), hw))
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("hw", [(16, 16), (32, 48), (7, 5), (512, 512)])
    def test_resize_bilinear_gradient(self, rng, hw):
        """The backward's contraction with the interpolation matrices: the
        adjoint of the float32 forward, held to ``F.interpolate``'s own
        backward on the CPU (the same float32 weights, summed in another
        order) and, at the small sizes, to ``jax.grad`` of the JAX resize
        (the same contraction with weights made in float64, which at 512^2
        move by up to ~1.5e-5 relative); each matrix row holds at most two
        weights summing to 1."""
        x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
        if hw == (512, 512):  # the decoder's 256^2 -> 512^2
            x = rng.normal(size=(1, 256, 256, 2)).astype(np.float32)
        g = rng.normal(size=(x.shape[0],) + hw + (x.shape[-1],)).astype(np.float32)
        xt = _t(x).requires_grad_()
        (resize.resize_bilinear(xt, hw) * _t(g)).sum().backward()
        xf = _t(x).requires_grad_()
        y = torch.nn.functional.interpolate(xf.permute(0, 3, 1, 2), size=hw,
                                            mode="bilinear", align_corners=True)
        (y.permute(0, 2, 3, 1) * _t(g)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), xf.grad.numpy(), **TOL)
        if hw != (512, 512):
            want = jax.grad(lambda v: (jresize.resize_bilinear(v, hw) * g).sum())(
                jnp.asarray(x))
            np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
        m = resize.interp_matrix(hw[0], x.shape[1], torch.zeros(()))
        np.testing.assert_allclose(m.sum(1).numpy(), 1.0, rtol=0, atol=1e-6)
        assert int((m != 0).sum(1).max()) <= 2


class TestMortonLayout:
    @pytest.mark.parametrize("reso", [4, 64, 256])
    def test_morton_cells_device(self, rng, reso):
        pts = rng.uniform(0.0, 1.0, (2, 500, 3)).astype(np.float32)
        pts[0, :3, :2] = [[0.0, 0.0], [1.0, 1.0], [0.99999994, 0.5]]
        mask = rng.random((2, 500)) > 0.3
        for pad in (int(jsorted.PAD_CELL_SENTINEL), reso * reso):
            got = tsorted.morton_cells_device(_t(pts), _t(mask), reso, pad)
            want = jsorted.morton_cells_device(jnp.asarray(pts), jnp.asarray(mask), reso, pad)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("reso", [2, 8, 64])
    def test_morton_to_plane(self, rng, reso):
        vec = rng.normal(size=(2, reso * reso, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            tsorted.morton_to_plane(_t(vec), reso).numpy(),
            np.asarray(jsorted.morton_to_plane(jnp.asarray(vec), reso)))

    def test_host_bucket(self, rng):
        pts = rng.uniform(0.0, 1.0, (700, 3)).astype(np.float32)
        mask = rng.random(700) > 0.1
        for a, b in zip(tsorted.host_morton_bucket(pts, mask, 32),
                        jsorted.host_morton_bucket(pts, mask, 32)):
            np.testing.assert_array_equal(a, b)
        x, y = rng.integers(0, 64, 50), rng.integers(0, 64, 50)
        np.testing.assert_array_equal(tsorted.morton_interleave_np(x, y, 6),
                                      jsorted.morton_interleave_np(x, y, 6))

    @pytest.mark.parametrize("reso,n", [(64, 1500), (256, 3000)])
    def test_aligned_layout_and_trim(self, rng, reso, n):
        assert tsorted.aligned_bucket_size(n, reso) == jsorted.aligned_bucket_size(n, reso)
        b = 3
        npad = tsorted.aligned_bucket_size(n, reso)
        outs = {"t": [], "j": []}
        for i in range(b):
            pts = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
            mask = np.arange(n) < (n - 100 * i)
            outs["t"].append(tsorted.host_morton_bucket_aligned(pts, mask, reso))
            outs["j"].append(jsorted.host_morton_bucket_aligned(pts, mask, reso))
        for a, c in zip(outs["t"], outs["j"]):
            assert sorted(a) == sorted(c)
            for k in a:
                np.testing.assert_array_equal(a[k], c[k], err_msg=k)
        stack = [np.stack([o[k] for o in outs["t"]])
                 for k in ("points", "mask", "cells", "tile_offsets")]
        assert stack[0].shape[1] == npad
        for a, c in zip(tsorted.trim_aligned_batch(*stack),
                        jsorted.trim_aligned_batch(*stack)):
            np.testing.assert_array_equal(a, np.asarray(c))

    def test_aligned_numpy_path_matches_native(self, rng):
        """The port's numpy composition builds the same layout as the JAX
        package's native C++ fast path."""
        from tomosar2height_tpu import native

        pts = rng.uniform(0.0, 1.0, (900, 3)).astype(np.float32)
        mask = rng.random(900) > 0.1
        npad = jsorted.aligned_bucket_size(900, 64)
        fast = native.morton_align(pts, mask, 64, tsorted.PCHUNK, tsorted.ALIGNED_TILE_CELLS,
                                   npad, int(tsorted.PAD_CELL_SENTINEL))
        assert fast is not None, "the JAX package's native runtime did not build"
        mine = tsorted.host_morton_bucket_aligned(pts, mask, 64)
        assert sorted(mine) == sorted(fast)
        for k in fast:
            np.testing.assert_array_equal(mine[k], fast[k], err_msg=k)
