"""Training on the ``fused`` and ``cumsum`` layouts against the JAX package
on the CPU, and the backwards of the ``fused`` tile functions.

- One Trainer mini-step on the ``fused`` layout (256-cell tiles; the port's
  K9/K10/K12 Functions and their backwards on their plain versions here) and
  on the plain sorted layout of ``cumsum``: the loss and every parameter's
  gradient against ``jax.grad`` of the JAX ``Trainer._loss``, on the same
  layout for ``fused`` (the JAX model runs its Pallas kernels in interpret
  mode), on the same rows' plain path for ``cumsum`` (see the test), same
  weights through the bridge. The port runs in float64 (a ReLU gate at
  the kink flips between f32 runs: ``test_torch_train.py``), at 2e-4 *
  max|g| + 2e-4 rel per parameter; the f32 loss at 1e-5.
- The backward plain versions against the JAX custom_vjps' rules
  (``ops/pallas/fused.py``): K9's (``_tile_gather_bwd``), K10's
  (``_tile_pool_bwd``: max and mean, and a layout whose cells tie in their
  max, where the cotangent splits evenly, the JAX segment_max vjp's rule)
  and K12's (``_tile_scatter_bwd``) at 1e-5.
- ``pallas`` does not train in either package: the JAX kernel has no vjp,
  the port's is forward-only, and ``cli.train`` refuses the layout.

Torch runs on one thread here (the tier-1 workers share the cores).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_cuda import tile_batch  # noqa: E402
from test_torch_train import B, N, OUT, RESO, _assert_tree_close, train_cfg  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops.pallas import fused as jfused  # noqa: E402
from tomosar2height_tpu.ops.pallas.scatter_kernel import pallas_scatter_mean  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu_torch.models import build_model, init_weights  # noqa: E402
from tomosar2height_tpu_torch.ops import fused  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import (  # noqa: E402
    aligned_bucket_size,
    host_morton_bucket,
    host_morton_bucket_aligned,
)
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    load_flax_params,
    state_dict_to_flax,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sorted_batch(seed: int, impl: str) -> dict:
    """One batch with targets on ``impl``'s layout, made with numpy: aligned
    with 256-cell tiles ('fused'), or plain sorted ('cumsum')."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.001, 0.999, (B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) > 0.05
    if impl == "fused":
        npad = aligned_bucket_size(N, RESO, tile_cells=256)
        out = {"points": np.full((B, npad, 3), 0.5, np.float32),
               "point_mask": np.zeros((B, npad), bool),
               "cell": np.zeros((B, npad), np.int32),
               "cell_offsets": np.zeros((B, RESO * RESO // 256 + 1), np.int32)}
        for i in range(B):
            a = host_morton_bucket_aligned(pts[i], mask[i], RESO, tile_cells=256)
            out["points"][i], out["point_mask"][i] = a["points"], a["mask"]
            out["cell"][i], out["cell_offsets"][i] = a["cells"], a["tile_offsets"]
    else:
        out = {"points": np.empty_like(pts), "point_mask": np.empty_like(mask),
               "cell": np.empty((B, N), np.int32),
               "cell_offsets": np.empty((B, RESO * RESO + 1), np.int32)}
        for i in range(B):
            order, out["cell"][i], out["cell_offsets"][i] = host_morton_bucket(
                pts[i], mask[i], RESO)
            out["points"][i], out["point_mask"][i] = pts[i][order], mask[i][order]
    out["patch_valid"] = np.ones(B, bool)
    out["dsm"] = rng.uniform(0.0, 30.0, (B, OUT, OUT)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    """Seeded Xavier weights (the port's init, the JAX package's scheme) as
    a flax tree: the JAX init would compile the network once more."""
    model = init_weights(build_model(train_cfg("cumsum"), device="cpu"),
                         torch.Generator().manual_seed(4))
    return state_dict_to_flax(model.state_dict())


@pytest.mark.parametrize("impl,seed", [("fused", 1), ("cumsum", 2)])
def test_step_matches_jax(params, impl, seed):
    """``cumsum`` is held to the JAX step on the same rows without the layout
    (its plain segment ops): the JAX cumsum path sums in float32, and its
    gradients are ~1.3e-3 * max|g| from its own plain path's (measured
    1.32e-3 on block3's fc_0 here), the port's float64 sums are not."""
    batch = sorted_batch(seed, impl)
    jbatch = batch if impl == "fused" else {
        k: v for k, v in batch.items() if k not in ("cell", "cell_offsets")}
    jtrainer = JaxTrainer(jax_build_model(train_cfg(impl)),
                          {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                          use_cloud=True, mesh=make_mesh(1), donate=False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtrainer._loss, has_aux=True))(
        params, jtrainer.prepare_batch(jbatch))
    model = load_flax_params(build_model(train_cfg(impl), device="cpu"), params)
    trainer = Trainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float32"})
    loss32, _ = trainer.loss(trainer.prepare_batch(batch))
    np.testing.assert_allclose(float(loss32.detach()), float(jloss), rtol=1e-5)
    model.double()
    dev = trainer.prepare_batch(batch)
    loss, _ = trainer.loss({**dev, "points": dev["points"].double()})
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, trainer.params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_tree_close(state_dict_to_flax(dict(zip(names, grads))),
                       jax.tree.map(np.asarray, jgrads), 2e-4)


def _chunked(cells):
    return jnp.asarray(cells.reshape(cells.shape[0], -1, 128))


def test_tile_gather_bwd_matches_jax():
    pts, mask, cells, toff, _ = tile_batch(21, n=500, reso=64)
    rng = np.random.default_rng(3)
    g = rng.normal(size=mask.shape + (12,)).astype(np.float32)
    for reso in (64, 32):
        ax, ay = jfused.make_aux(jnp.asarray(pts[..., :2]))
        plane = jnp.zeros((2, reso, reso, 12), jnp.float32)
        want = jax.jit(lambda res, g, r=reso: jfused._tile_gather_bwd(r, res, g)[0])(
            (plane, ax, ay, jnp.asarray(mask)), jnp.asarray(g))
        got = gk.tile_gather_bwd(torch.from_numpy(g), torch.from_numpy(pts[..., :2].copy()),
                                 torch.from_numpy(cells), torch.from_numpy(mask), reso, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_pool_bwd(kind, res, g):
    return jax.jit(lambda res, g: jfused._tile_pool_bwd(32, kind, res, g)[0])(res, g)


def _tie_batch():
    """tile_batch with values in {0, 1, 2}: most cells tie in their max."""
    _, mask, cells, toff, vals = tile_batch(43, n=600, reso=32, f=6)
    vals = np.random.default_rng(9).integers(0, 3, vals.shape).astype(np.float32)
    return mask, cells, toff, vals


@pytest.mark.parametrize("kind,ties", [("max", False), ("mean", False), ("max", True)])
def test_tile_pool_bwd_matches_jax(kind, ties):
    if ties:
        mask, cells, toff, vals = _tie_batch()
    else:
        _, mask, cells, toff, vals = tile_batch(41, n=600, reso=32, f=6)
    vals[~mask] = 0.0
    g = np.random.default_rng(5).normal(size=vals.shape).astype(np.float32)
    want = _jax_pool_bwd(kind, (jnp.asarray(vals), _chunked(cells), jnp.asarray(mask)),
                         jnp.asarray(g))
    v, c, tt, m = (torch.from_numpy(x) for x in (vals, cells, toff, mask))
    out = fused._masked(m, tpk.tile_pool(v, c, tt, kind))
    got = tpk.tile_pool_bwd(fused._masked(m, torch.from_numpy(g)), v, out, c, tt, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tile_pool_bwd_splits_ties_evenly():
    """A cell of three rows whose max ties on two: each tied row takes half
    the cell's cotangent sum, the third none (the JAX segment_max vjp)."""
    cells = np.array([[5, 5, 5, 7]], np.int32)
    toff = np.array([[0, 4, 4, 4, 4]], np.int32)  # the four 256-cell tiles of 32^2
    vals = np.array([[[2.0], [2.0], [1.0], [3.0]]], np.float32)
    mask = np.ones((1, 4), bool)
    g = np.array([[[1.0], [2.0], [4.0], [8.0]]], np.float32)
    want = _jax_pool_bwd("max", (jnp.asarray(vals), jnp.asarray(cells.reshape(1, 1, 4)),
                                 jnp.asarray(mask)), jnp.asarray(g))
    v, c, tt = (torch.from_numpy(x) for x in (vals, cells, toff))
    out = tpk.tile_pool(v, c, tt, "max")
    got = tpk.tile_pool_bwd(torch.from_numpy(g), v, out, c, tt, "max")
    np.testing.assert_array_equal(got.numpy()[0, :, 0], [3.5, 3.5, 0.0, 8.0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("reso", [32, 16])
def test_tile_scatter_bwd_matches_jax(reso):
    _, mask, cells, toff, vals = tile_batch(31, n=500, reso=32, f=8)
    lvl = toff[:, :: 4 ** (32 .bit_length() - reso.bit_length())]
    g = np.random.default_rng(33).normal(size=(2, reso, reso, 8)).astype(np.float32)
    want = jax.jit(lambda c, g: jfused._tile_scatter_bwd(reso, 32, c, g)[0])(
        _chunked(cells), jnp.asarray(g))
    _, counts = sk.aligned_scatter_mean_plane(torch.from_numpy(vals), torch.from_numpy(cells),
                                              torch.from_numpy(lvl), reso, 32,
                                              with_counts=True)
    got = sk.aligned_scatter_mean_plane_bwd(torch.from_numpy(g), torch.from_numpy(cells),
                                            counts, reso, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[~mask] == 0).all()


def test_pallas_does_not_train(params):
    """Neither package differentiates the plain-sorted tile scatter-mean."""
    from test_torch_cuda import sorted_batch as k11_batch

    vals, cells, offs = k11_batch(3)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda v: pallas_scatter_mean(v, jnp.asarray(cells), jnp.asarray(offs), 32,
                                               interpret=True).sum())(jnp.asarray(vals))
    model = load_flax_params(build_model(train_cfg("pallas"), device="cpu"), params)
    trainer = Trainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float32"})
    with pytest.raises(RuntimeError, match="forward-only"):
        trainer.train_step(sorted_batch(1, "cumsum"), 1e-3)


def test_cli_train_refuses_pallas():
    from tomosar2height_tpu_torch.cli import train as cli_train

    with pytest.raises(NotImplementedError, match="no gradient either"):
        cli_train.run(["dataset=synthetic", "device.platform=cpu",
                       "dataset.points.sort=true", "model.encoder_kwargs.sorted_impl=pallas"])


@pytest.mark.parametrize("impl,reso", [("cumsum", 32), ("cumsum", 16), ("cumsum", 8),
                                       ("fused", 16), ("fused", 8)])
def test_sorted_sample_backward_on_the_d_plane_pass(impl, reso):
    """``fused.sorted_sample`` (the sample of the sorted layouts without K9:
    ``cumsum``, and ``fused`` below 32^2) differentiates through K5's
    d_plane pass. Its card steps (``test_torch_level_runs.emulate_d_plane``:
    the mark pass over the finest cells' row ranges, a pixel's rectangle of
    cells walked in a fixed order) on the plain sorted layout, whose pads sit
    at the end with cell id RESO^2, and on the aligned layout of 256-cell
    tiles, below the finest resolution: within K5's tolerance of the plain
    transpose, every pixel stored once; and the CPU wrapper's gradient equal
    to grid_sample_2d's autograd on the masked cotangent (float64, up to
    rounding)."""
    from test_torch_level_runs import PLANE_TOL, emulate_d_plane

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
    from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d

    b = sorted_batch(4, impl)
    xy, mask, cells = b["points"][..., :2], b["point_mask"], b["cell"]
    rng = np.random.default_rng(reso)
    g = rng.normal(size=mask.shape + (4,)).astype(np.float32)
    got, writes, _ = emulate_d_plane(g, xy, cells, mask, reso, fr=RESO)
    assert (writes == 1).all()
    want = lk.level_d_plane_plain(*(torch.from_numpy(a) for a in (g, xy, cells, mask)), reso,
                                  RESO)
    np.testing.assert_allclose(got, want.numpy(), **PLANE_TOL)
    plane = torch.from_numpy(rng.normal(size=(B, reso, reso, 4))).requires_grad_()
    xy64, gt = torch.from_numpy(xy).double(), torch.from_numpy(g).double()
    m = torch.from_numpy(mask)
    (d,) = torch.autograd.grad(fused.sorted_sample(plane, xy64, m, torch.from_numpy(cells),
                                                   RESO), plane, gt)
    (ref,) = torch.autograd.grad(grid_sample_2d(plane, xy64), plane,
                                 torch.where(m[..., None], gt, 0.0))
    np.testing.assert_allclose(d.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def test_cumsum_backwards_in_a_fixed_order():
    """The cumsum path's backwards that replace scatters (each a gather or a
    sorted running sum; its samples' is K5's d_plane pass, above): the
    segment sums' and the gather-back's against autograd of their plain
    forms (float64: equal up to rounding)."""
    from tomosar2height_tpu_torch.ops import sorted_scatter as ss

    rng = np.random.default_rng(8)
    b = sorted_batch(3, "cumsum")
    offs, cells = torch.from_numpy(b["cell_offsets"]), torch.from_numpy(b["cell"])
    v = torch.from_numpy(rng.normal(size=(B, N, 4))).requires_grad_()
    gs = torch.from_numpy(rng.normal(size=(B, RESO * RESO, 4)))
    (got,) = torch.autograd.grad(ss.sorted_segment_sum_counts(v, offs)[0], v, gs)
    valid = torch.arange(N)[None, :] < offs[:, -1:]
    want = torch.where(valid[..., None], ss.gather_cells_sorted(gs, cells), 0.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    cv = torch.from_numpy(rng.normal(size=(B, RESO * RESO, 4))).requires_grad_()
    gr = torch.from_numpy(rng.normal(size=(B, N, 4)))
    (got,) = torch.autograd.grad(ss.gather_sorted_rows(cv, cells, offs), cv, gr)
    (want,) = torch.autograd.grad(ss.gather_cells_sorted(cv, cells), cv, gr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
