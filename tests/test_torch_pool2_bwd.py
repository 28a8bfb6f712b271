"""K1's ``sum`` kind and the backwards of ``pool2`` and ``scatter_plane2`` in
the port (``ops/cuda/pool2_kernel.py``, their plain versions on the CPU)
against the JAX package: ``chunkgrid_pool(..., 'sum')`` and ``jax.grad`` of
the JAX ``pool2`` / ``scatter_plane2``, whose custom_vjps run the Pallas K1/K2
in interpret mode off-TPU. Max pooling's backward gives every point tied with
its cell's max the whole cell sum of the cotangent (pool2_kernel.py:506-508);
the batches hold explicit ties. Tolerance 1e-5 (abs and rel), the K1/K2
forward tolerance: these are sums of a few terms. The CUDA kernels are held
to these plain versions on a card by ``test_torch_cuda.py``."""

from __future__ import annotations

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
    chunkgrid_pool,
    pool2 as jax_pool2,
    scatter_plane2 as jax_scatter_plane2,
)
from test_torch_cuda import RESO, aligned_batch, t, tied_batch  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_TILES = RESO * RESO // 1024


def _meta(cells, toff, npad):
    ct, _ = chunk_metadata(jnp.asarray(toff), npad, RESO, RESO)
    return (make_cells_row(jnp.asarray(cells)), ct,
            empty_tile_mask(jnp.asarray(toff), RESO, RESO))


@pytest.fixture(scope="module", params=["clustered", "tied"])
def batch(request):
    return aligned_batch(0) if request.param == "clustered" else tied_batch(0)


def _cot(vals, seed):
    return np.random.default_rng(seed).normal(size=vals.shape).astype(np.float32)


class TestSumKind:
    def test_matches_jax_chunkgrid_sum(self, batch):
        _, mask, cells, toff, vals = batch
        cells_row, ct, _ = _meta(cells, toff, mask.shape[1])
        want = np.asarray(chunkgrid_pool(jnp.asarray(vals), cells_row, ct, N_TILES, "sum"))
        cellv = pk.pool_reduce(t(vals), t(cells), t(mask), RESO * RESO, "sum")
        got = pk.pool_gather(cellv, t(cells), t(mask)).numpy()
        np.testing.assert_allclose(got, np.where(mask[..., None], want, 0), **TOL)
        # an empty cell sums to 0, and the sum is count * mean
        mean = pk.pool_reduce(t(vals), t(cells), t(mask), RESO * RESO, "mean")
        counts = np.zeros(cellv.shape[:2], np.int64)
        for i in range(mask.shape[0]):
            np.add.at(counts[i], cells[i][mask[i]], 1)
        np.testing.assert_allclose(cellv.numpy(), mean.numpy() * counts[..., None], **TOL)
        assert (cellv.numpy()[counts == 0] == 0).all()


class TestPool2Backward:
    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_matches_jax_grad(self, batch, kind):
        _, mask, cells, toff, vals = batch
        cells_row, ct, _ = _meta(cells, toff, mask.shape[1])
        g = _cot(vals, 1)

        def loss(v):
            return jnp.sum(jax_pool2(v, cells_row, ct, jnp.asarray(mask), N_TILES, kind) * g)

        want = np.asarray(jax.grad(loss)(jnp.asarray(vals)))
        v = t(vals).requires_grad_()
        (got,) = torch.autograd.grad((pk.pool2(v, t(cells), t(mask), RESO, kind)
                                      * t(g)).sum(), v)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert (got.numpy()[~mask] == 0).all()

    def test_every_tie_gets_the_whole_cell_sum(self):
        _, mask, cells, _, vals = tied_batch(0)
        g = _cot(vals, 2)
        v = t(vals).requires_grad_()
        out = pk.pool2(v, t(cells), t(mask), RESO, "max")
        (got,) = torch.autograd.grad((out * t(g)).sum(), v)
        got, out = got.numpy(), out.detach().numpy()
        ties = 0
        for i in range(mask.shape[0]):
            for c in np.unique(cells[i][mask[i]]):
                rows = np.flatnonzero(mask[i] & (cells[i] == c))
                total = g[i, rows].sum(0)
                top = vals[i, rows] == out[i, rows]
                ties += int((top.sum(0) > 1).sum())
                np.testing.assert_allclose(got[i, rows], np.where(top, total, 0), **TOL)
        assert ties > 20  # the batch really holds tied maxima

    def test_plain_backward_matches_autograd_of_plain_mean(self, batch):
        """The mean pool is linear: its written-out backward equals autograd
        through the plain forward."""
        _, mask, cells, _, vals = batch
        g = t(_cot(vals, 3))
        v = t(vals).requires_grad_()
        (want,) = torch.autograd.grad((pk.pool2_plain(v, t(cells), t(mask), RESO, "mean")
                                       * g).sum(), v)
        got = pk.pool2_bwd_plain(g, t(vals), None, t(cells), t(mask), RESO, "mean")
        torch.testing.assert_close(got, want, **TOL)


class TestScatterPlane2Backward:
    def test_matches_jax_grad(self, batch):
        _, mask, cells, toff, vals = batch
        cells_row, ct, tmask = _meta(cells, toff, mask.shape[1])
        g = np.random.default_rng(4).normal(
            size=(vals.shape[0], RESO, RESO, vals.shape[-1])).astype(np.float32)

        def loss(v):
            return jnp.sum(jax_scatter_plane2(v, cells_row, ct, tmask,
                                              jnp.asarray(mask), RESO) * g)

        want = np.asarray(jax.grad(loss)(jnp.asarray(vals)))
        v = t(vals).requires_grad_()
        plane, counts = pk.scatter_plane2(v, t(cells), t(mask), RESO)
        assert not counts.requires_grad
        (got,) = torch.autograd.grad((plane * t(g)).sum(), v)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # and against autograd through the plain forward
        v2 = t(vals).requires_grad_()
        (plain,) = torch.autograd.grad(
            (pk.scatter_plane2_plain(v2, t(cells), t(mask), RESO)[0] * t(g)).sum(), v2)
        torch.testing.assert_close(got, plain, **TOL)
