"""Kernels K1-K3 of the PyTorch port (``ops/cuda/pool2_kernel.py``): their
plain versions against the JAX ``pool2`` / ``scatter_plane2`` (Pallas, in
interpret mode off-TPU) on the same Morton-aligned inputs, covering ties,
empty cells, pad rows and an empty patch. Tolerance 1e-5; max pooling exact.
The CUDA kernels themselves are held to these plain versions on a card by
``test_torch_cuda.py``."""

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
from tomosar2height_tpu.ops.pallas.pool2_kernel import pool2 as jax_pool2  # noqa: E402
from tomosar2height_tpu.ops.pallas.pool2_kernel import (  # noqa: E402
    scatter_plane2 as jax_scatter_plane2,
)
from test_torch_cuda import RESO, aligned_batch, t  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk  # noqa: E402

F = 8


def _jax_meta(cells, toff, npad, reso=RESO):
    ct, _ = chunk_metadata(jnp.asarray(toff), npad, reso, reso)
    return make_cells_row(jnp.asarray(cells)), ct, empty_tile_mask(jnp.asarray(toff), reso, reso)


@pytest.fixture(scope="module")
def batch():
    return aligned_batch(0)


class TestPlainVsJax:
    @pytest.mark.parametrize("kind", ["max", "mean"])
    def test_pool2(self, batch, kind):
        pts, mask, cells, toff, vals = batch
        cells_row, ct, _ = _jax_meta(cells, toff, mask.shape[1])
        want = np.asarray(jax_pool2(jnp.asarray(vals), cells_row, ct, jnp.asarray(mask),
                                    RESO * RESO // 1024, kind))
        got = pk.pool2(t(vals), t(cells), t(mask), RESO, kind).numpy()
        assert (got[~mask] == 0).all()
        if kind == "max":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_scatter_plane2(self, batch):
        pts, mask, cells, toff, vals = batch
        cells_row, ct, tmask = _jax_meta(cells, toff, mask.shape[1])
        want = np.asarray(jax_scatter_plane2(jnp.asarray(vals), cells_row, ct, tmask,
                                             jnp.asarray(mask), RESO))
        plane, counts = pk.scatter_plane2(t(vals), t(cells), t(mask), RESO)
        np.testing.assert_allclose(plane.numpy(), want, rtol=1e-5, atol=1e-5)
        assert counts.dtype == torch.int32 and int(counts.sum()) == int(mask.sum())
        assert (plane.numpy()[-1] == 0).all()  # the empty patch
        assert (plane.numpy()[counts.numpy() == 0] == 0).all()  # empty cells

    def test_reduce_gather_halves(self, batch):
        pts, mask, cells, toff, vals = batch
        ncell = RESO * RESO
        cellv = pk.pool_reduce(t(vals), t(cells), t(mask), ncell, "max")
        assert cellv.shape == (vals.shape[0], ncell, F)
        np.testing.assert_array_equal(
            pk.pool_gather(cellv, t(cells), t(mask)).numpy(),
            pk.pool2(t(vals), t(cells), t(mask), RESO, "max").numpy())

    def test_rejects_other_devices_and_kinds(self, batch):
        _, mask, cells, _, vals = batch
        with pytest.raises(ValueError):
            pk.pool_reduce(t(vals), t(cells), t(mask), RESO * RESO, "min")
        with pytest.raises(ValueError):  # K1 sums, but pool2 has no 'sum' pooling
            pk.pool2(t(vals), t(cells), t(mask), RESO, "sum")
        with pytest.raises(ValueError, match="device"):
            pk.pool2(t(vals).to("meta"), t(cells), t(mask), RESO, "max")

