"""The backward of the port's fused level (``ops/cuda/level_kernel.py``, K5's
plain version on the CPU) against ``jax.grad`` of the JAX ``fused_level``,
whose backward is the Pallas K5 (``level_bwd_kernel.py``, in interpret mode
off-TPU), at the shapes of tests/test_fused_level_bwd.py plus an empty batch
row. Tolerances are that test's: 2e-5 abs + 2e-4 rel for d_plane and d_c_last,
3e-5 abs + 3e-4 rel for the weights. The plain backward is also held to
``torch.autograd.grad`` of the plain forward. The CUDA kernel itself is held
to the plain backward on a card by ``test_torch_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.ops.pallas.level_kernel import (  # noqa: E402
    chunk_metadata,
    empty_tile_mask,
    fused_level as jax_fused_level,
    make_aux_packed,
    make_cells_row,
)
from test_torch_cuda import level_cotangents, level_inputs, t  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk  # noqa: E402

PLANE_TOL = dict(atol=2e-5, rtol=2e-4)
WEIGHT_TOL = dict(atol=3e-5, rtol=3e-4)
NAMES = ("w_in", "b_in", "w_out", "b_out", "w_c", "b_c")


def jax_grads(inp, g_p, g_c, reso, level_reso):
    pts, mask, cells, toff, plane, c_last, weights = inp
    npad = mask.shape[1]
    ct, pt = chunk_metadata(jnp.asarray(toff), npad, level_reso, reso)
    tmask = empty_tile_mask(jnp.asarray(toff), level_reso, reso)
    aux = make_aux_packed(jnp.asarray(pts[..., :2]))
    cells_row = make_cells_row(jnp.asarray(cells))

    def loss(p, cl, w):
        po, co = jax_fused_level(p, cl, w, aux, cells_row, ct, pt, tmask,
                                 jnp.asarray(mask), level_reso, reso)
        return jnp.sum(po * g_p) + jnp.sum(co * g_c)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(plane), jnp.asarray(c_last), tuple(jnp.asarray(w) for w in weights))
    return jax.tree.map(np.asarray, grads)


def port_grads(inp, g_p, g_c, reso, level_reso, fn=lk.fused_level):
    pts, mask, cells, _, plane, c_last, weights = inp
    p = t(plane).requires_grad_()
    cl = t(c_last).requires_grad_()
    w = tuple(t(x).requires_grad_() for x in weights)
    po, co, _ = fn(p, cl, w, t(pts[..., :2]), t(cells), t(mask), level_reso, reso)
    loss = (po * t(g_p)).sum() + (co * t(g_c)).sum()
    dp, dcl, *dw = torch.autograd.grad(loss, (p, cl) + w)
    return dp.numpy(), dcl.numpy(), [x.numpy() for x in dw]


SHAPES = [
    (64, 64, 8, 4),    # finest-resolution level, odd channel counts
    (64, 32, 16, 16),  # coarsened level (cells >> shift)
    (32, 32, 8, 8),    # minimum window resolution
]


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **PLANE_TOL, err_msg="d_plane")
    np.testing.assert_allclose(got[1], want[1], **PLANE_TOL, err_msg="d_c_last")
    for a, b, name in zip(got[2], want[2], NAMES):
        np.testing.assert_allclose(a, b, **WEIGHT_TOL, err_msg=name)


class TestLevelBackwardVsJax:
    @pytest.mark.parametrize("reso,level_reso,f,fl", SHAPES)
    def test_matches_jax_grad(self, reso, level_reso, f, fl):
        inp = level_inputs(reso, level_reso, f, fl, seed=reso + f)
        g_p, g_c = level_cotangents(inp, seed=1)
        _check(port_grads(inp, g_p, g_c, reso, level_reso),
               jax_grads(inp, g_p, g_c, reso, level_reso))

    def test_empty_batch_row(self):
        """A patch with no points gives exact zeros. The JAX K5 leaves the
        windows of unvisited tiles unwritten and masks them by multiplying
        with 0 (windows_to_plane), so its d_plane for an all-padding row is
        NaN in interpret mode: only the other rows are compared there."""
        inp = level_inputs(32, 32, 8, 8, seed=3, empty_last=True)
        g_p, g_c = level_cotangents(inp, seed=2)
        got = port_grads(inp, g_p, g_c, 32, 32)
        want = jax_grads(inp, g_p, g_c, 32, 32)
        _check((got[0][:-1],) + got[1:], (want[0][:-1],) + tuple(want[1:]))
        assert (got[0][-1] == 0).all() and (got[1][-1] == 0).all()


class TestPlainBackward:
    @pytest.mark.parametrize("reso,level_reso,f,fl", SHAPES)
    def test_matches_autograd_of_plain_forward(self, reso, level_reso, f, fl):
        """K5's written-out math against autograd through fused_level_plain."""
        inp = level_inputs(reso, level_reso, f, fl, seed=11, empty_last=True)
        g_p, g_c = level_cotangents(inp, seed=4)
        _check(port_grads(inp, g_p, g_c, reso, level_reso),
               port_grads(inp, g_p, g_c, reso, level_reso, fn=lk.fused_level_plain))

    def test_counts_not_differentiable(self):
        inp = level_inputs(32, 32, 8, 8, seed=5)
        pts, mask, cells, _, plane, c_last, weights = inp
        p = t(plane).requires_grad_()
        _, _, counts = lk.fused_level(p, t(c_last), tuple(t(w) for w in weights),
                                      t(pts[..., :2]), t(cells), t(mask), 32, 32)
        assert not counts.requires_grad and counts.dtype == torch.int32
