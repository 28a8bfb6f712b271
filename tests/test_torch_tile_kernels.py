"""The tile kernels of the Morton-sorted serving paths (K9-K14) in the
PyTorch port, held on the CPU to the JAX package's Pallas kernels run in
interpret mode, on the same numpy inputs (made by ``test_torch_cuda.py``).

The port's wrappers take their plain versions on a CPU tensor; the CUDA
kernels are held to those plain versions on a card by ``test_torch_cuda.py``
and ``chip_smoke.py``. Tolerance 1e-5 (rtol and atol) for each op, 2e-4 for
the gradients of the differentiable wrappers against the JAX custom_vjps.
The edge cases are those of tests/test_pallas_aligned.py and
tests/test_pallas_kernel.py: an empty batch entry, border points, every
point in one cell, a plane coarser than the layout's finest.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.ops.pallas import fused as jfused  # noqa: E402
from tomosar2height_tpu.ops.pallas.gather_kernel import pallas_tile_gather  # noqa: E402
from tomosar2height_tpu.ops.pallas.pool_kernel import pallas_tile_pool  # noqa: E402
from tomosar2height_tpu.ops.pallas.scatter_kernel import (  # noqa: E402
    pallas_aligned_scatter_mean_plane,
    pallas_scatter_mean,
    pallas_scatter_mean_plane,
    pallas_scatter_mean_plane_v3,
)
from tomosar2height_tpu.ops import sorted_scatter as jss  # noqa: E402
from test_torch_cuda import sorted_batch, t, tile_batch  # noqa: E402
from tomosar2height_tpu_torch.ops import fused  # noqa: E402
from tomosar2height_tpu_torch.ops import sorted_scatter as ss  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _level(reso, finest):
    return finest.bit_length() - reso.bit_length()


def _chunked(cells):
    return jnp.asarray(cells.reshape(cells.shape[0], -1, 128))


class TestTileGather:
    @pytest.mark.parametrize("reso,finest,edge", [(32, 64, "empty"), (32, 32, "border")])
    def test_matches_jax(self, reso, finest, edge):
        pts, mask, _, toff, _ = tile_batch(5, n=800, reso=finest, edge=edge)
        plane = np.random.default_rng(13).normal(size=(2, reso, reso, 24)).astype(np.float32)
        lvl = toff[:, :: 4 ** _level(reso, finest)]
        ax, ay = jfused.make_aux(jnp.asarray(pts[..., :2]))
        want = np.asarray(pallas_tile_gather(jnp.asarray(plane), ax, ay, jnp.asarray(lvl),
                                             reso, interpret=True))
        got = gk.tile_gather(t(plane), t(pts[..., :2]), t(lvl)).numpy()
        # the JAX kernel leaves rows past the last tile undefined: compare
        # the points; the port writes 0 past the last tile
        np.testing.assert_allclose(got[mask], want[mask], **TOL)
        past = np.arange(mask.shape[1])[None, :] >= lvl[:, -1:]
        assert (got[past] == 0).all()

    def test_grad_matches_jax_vjp(self):
        pts, mask, cells, toff, _ = tile_batch(21, n=300, reso=32)
        rng = np.random.default_rng(23)
        plane = rng.normal(size=(2, 32, 32, 16)).astype(np.float32)
        cot = rng.normal(size=mask.shape + (16,)).astype(np.float32)
        ax, ay = jfused.make_aux(jnp.asarray(pts[..., :2]))
        want = jax.grad(lambda p: (jfused.tile_gather(
            p, ax, ay, jnp.asarray(mask), jnp.asarray(toff), 32) * cot).sum())(
                jnp.asarray(plane))
        p = t(plane).requires_grad_()
        (fused.tile_gather(p, t(pts[..., :2]), t(mask), t(cells), t(toff), 32, 32)
         * t(cot)).sum().backward()
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), **GRAD_TOL)


class TestTilePool:
    @pytest.mark.parametrize("kind,edge", [("max", "none"), ("mean", "none"),
                                           ("max", "one_cell"), ("mean", "empty")])
    def test_matches_jax(self, kind, edge):
        _, mask, cells, toff, vals = tile_batch(41, n=900, reso=64, f=24, edge=edge)
        vals[~mask] = -1e9 if kind == "max" else 1e9
        want = np.asarray(pallas_tile_pool(jnp.asarray(vals), _chunked(cells),
                                           jnp.asarray(toff), kind, interpret=True))
        got = tpk.tile_pool(t(vals), t(cells), t(toff), kind).numpy()
        np.testing.assert_allclose(got[mask], want[mask], **TOL)
        assert (got[~mask] == 0).all()

    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_grad_matches_jax_vjp(self, kind):
        _, mask, cells, toff, vals = tile_batch(43, n=400, reso=32, f=8)
        vals[~mask] = 0.0
        cot = np.random.default_rng(44).normal(size=vals.shape).astype(np.float32)
        want = jax.grad(lambda v: (jfused.tile_pool(
            v, _chunked(cells), jnp.asarray(toff), jnp.asarray(mask), 32, kind)
            * cot).sum())(jnp.asarray(vals))
        v = t(vals).requires_grad_()
        (fused.tile_pool(v, t(cells), t(toff), t(mask), 32, kind) * t(cot)).sum().backward()
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), **GRAD_TOL)


class TestTileScatterMean:
    @pytest.mark.parametrize("reso,finest,edge", [
        (64, 64, "none"), (32, 64, "none"), (16, 64, "one_cell"), (32, 32, "empty")])
    def test_aligned_matches_jax(self, reso, finest, edge):
        """K12: tile offsets at this resolution."""
        _, _, cells, toff, vals = tile_batch(7, n=900, reso=finest, edge=edge)
        lvl = toff[:, :: 4 ** _level(reso, finest)]
        want = np.asarray(pallas_aligned_scatter_mean_plane(
            jnp.asarray(vals), _chunked(cells), jnp.asarray(lvl), reso, finest,
            interpret=True))
        got = sk.aligned_scatter_mean_plane(t(vals), t(cells), t(lvl), reso, finest)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        if edge == "empty":
            assert (got[-1] == 0).all()

    @pytest.mark.parametrize("reso,finest", [(64, 64), (32, 64)])
    def test_v3_matches_jax(self, reso, finest):
        """K14: the finest tile offsets, coarsened inside."""
        _, _, cells, toff, vals = tile_batch(8, n=900, reso=finest)
        want = np.asarray(pallas_scatter_mean_plane_v3(
            jnp.asarray(vals), _chunked(cells), jnp.asarray(toff), reso, finest,
            interpret=True))
        got = sk.scatter_mean_plane_v3(t(vals), t(cells), t(toff), reso, finest)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_grad_matches_jax_vjp(self):
        _, mask, cells, toff, vals = tile_batch(31, n=400, reso=32, f=8)
        cot = np.random.default_rng(33).normal(size=(2, 32, 32, 8)).astype(np.float32)
        want = jax.grad(lambda v: (jfused.tile_scatter_mean(
            v, _chunked(cells), jnp.asarray(toff), 32, 32) * cot).sum())(jnp.asarray(vals))
        v = t(vals).requires_grad_()
        (fused.tile_scatter_mean(v, t(cells), t(toff), 32, 32) * t(cot)).sum().backward()
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), **GRAD_TOL)
        assert (v.grad.numpy()[~mask] == 0).all()


class TestSortedScatterMean:
    @pytest.mark.parametrize("reso,f,one_cell", [(32, 8, False), (16, 4, False),
                                                 (16, 4, True)])
    def test_matches_jax(self, reso, f, one_cell):
        """K11 (row-major plane) and K13 (Morton cell vector) on the plain
        sorted layout; reso 16 is a single tile."""
        vals, cells, offs = sorted_batch(3, reso=reso, f=f, one_cell=one_cell)
        args = (jnp.asarray(vals), jnp.asarray(cells), jnp.asarray(offs), reso)
        want_plane = np.asarray(pallas_scatter_mean_plane(*args, interpret=True))
        want_vec = np.asarray(pallas_scatter_mean(*args, interpret=True))
        got_plane = sk.scatter_mean_plane(t(vals), t(cells), t(offs), reso)
        got_vec = sk.scatter_mean(t(vals), t(cells), t(offs), reso)
        np.testing.assert_allclose(got_plane.numpy(), want_plane, **TOL)
        np.testing.assert_allclose(got_vec.numpy(), want_vec, **TOL)

    def test_forward_only(self):
        vals, cells, offs = sorted_batch(3)
        v = t(vals).requires_grad_()
        for fn in (sk.scatter_mean_plane, sk.scatter_mean):
            with pytest.raises(RuntimeError, match="forward-only"):
                fn(v, t(cells), t(offs), 32)
        with torch.no_grad():
            assert sk.scatter_mean(v, t(cells), t(offs), 32).shape == (2, 1024, 8)


class TestSortedScatterOps:
    """The device half of ops/sorted_scatter.py against the JAX module."""

    def test_cumsum_path_matches_jax(self):
        vals, cells, offs = sorted_batch(4, reso=32, f=6)
        want = np.asarray(jss.scatter_mean_plane_morton(
            jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(cells), 32, "cumsum"))
        got = ss.scatter_mean_plane_morton(t(vals), t(offs), t(cells), 32, "cumsum")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        for impl in ("cumsum", "pallas"):  # the pallas path through K11 (plain here)
            got = ss.scatter_mean_plane_morton(t(vals), t(offs), t(cells), 32, impl)
            np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_coarsened_levels_match_jax(self):
        vals, cells, offs = sorted_batch(5, reso=64, f=4)
        for level in (1, 2):
            reso = 64 >> level
            j_off = jss.coarsen_offsets(jnp.asarray(offs), level)
            want = np.asarray(jss.scatter_mean_morton(
                jnp.asarray(vals), j_off, jnp.asarray(cells) >> (2 * level), reso))
            p_off = ss.coarsen_offsets(t(offs), level)
            np.testing.assert_array_equal(p_off.numpy(), np.asarray(j_off))
            for impl in ("cumsum", "pallas"):
                got = ss.scatter_mean_morton(t(vals), p_off, t(cells) >> (2 * level), reso,
                                             impl)
                np.testing.assert_allclose(got.numpy(), want, **TOL)
        toff = np.arange(17, dtype=np.int32)[None]
        np.testing.assert_array_equal(ss.coarsen_tile_offsets(t(toff), 1).numpy(),
                                      np.asarray(jss.coarsen_tile_offsets(toff, 1)))

    def test_gather_cells_sorted_and_dispatch_below_a_tile(self):
        vals, cells, offs = sorted_batch(6, reso=8, f=4)
        # reso 8 holds no whole 256-cell tile: 'pallas' takes the cumsum path
        want = np.asarray(jss.scatter_mean_morton(
            jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(cells), 8, "pallas"))
        got = ss.scatter_mean_morton(t(vals), t(offs), t(cells), 8, "pallas")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        back = ss.gather_cells_sorted(got, t(cells))  # pads (id 64) clip to cell 63
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jss.gather_cells_sorted(jnp.asarray(got.numpy()),
                                                             jnp.asarray(cells))))
