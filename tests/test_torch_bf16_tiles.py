"""bf16 on the ``fused``, ``pallas`` and ``cumsum`` layouts
(``model.dtype=bfloat16`` with ``dataset.points.sort=true``): the port
against the JAX package on the CPU, its Pallas kernels in bf16 in interpret
mode. The port runs its plain versions here (CPU tensors); the CUDA kernels
are held to them on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

- K9-K14 in bf16 against the JAX kernels in bf16 (bf16 in, bf16 out; ties,
  an empty entry, border points, and cells of more than 256 rows): the
  samples, the max and the means within one bf16 ulp (measured: bit-equal),
  K12's counts equal to the layout's.
- The backwards, each against JAX's vjp on the same bf16 inputs and
  cotangents, its f32 vjp on the same values, and JAX's bf16 gate
  ``max(1.5 x err(JAX bf16, f32), 0.02 x scale)``
  (tests/test_fused_level_bwd.py:184-190):
  - K9's: the transpose of K9's forward, the coordinates f32 (JAX's bf16
    vjp samples at bf16-rounded coordinates, ~0.5 off its f32 vjp at scale
    3.6; the port ~0.012): within the gate of the f32 vjp and of JAX's bf16
    one;
  - K10's (max with ties and mean, a cell of 800 rows) and the ``cumsum``
    sample's (an f32 cotangent into a bf16 plane): the port sums in f32 and
    rounds each output once, so it lies within one bf16 ulp of JAX's f32
    vjp; JAX's bf16 vjp adds in bf16 through XLA (thousands of ulps off on
    the 800-row cell), held by the gate;
  - K12's: the cotangent over the count cast to bf16, as JAX divides
    (fused.py:170): bit-equal, a cell of more than 256 rows included;
  - ``cumsum``'s scatter-mean (its float64 running sums against JAX's f32)
    within one bf16 ulp both ways, and its max pooling (``segment_max`` and
    the gather-back) as K10's.
- The cloud+image network at ``tests/test_torch_bf16.py``'s size served in
  bf16 on ``fused`` and ``cumsum``: its heights no further from JAX's f32
  heights than 2x JAX's bf16 heights on the same layout are (max and mean
  |d|), and JAX's gate (0.15 x scale, correlation > 0.99;
  tests/test_bf16.py:14-39); a dtype map of every module's output against
  flax's ``capture_intermediates``. ``pallas`` against JAX's bf16 ``cumsum``
  model the same way (the JAX ``pallas`` model cannot run on the CPU: its
  K11/K13 launchers leave interpret mode off). JAX's f32 references run its
  unsorted plain path, which its sorted f32 paths match to 2e-4 x z_scale.
- One L1 ``Trainer`` step in bf16 on ``fused`` and on ``cumsum`` against
  JAX's f32 step and its bf16 step on the same layout, under
  ``tests/test_torch_bf16.py``'s gradient rule; ``pallas`` does not train in
  bf16 either.

The weights are flax's init with biases drawn at std 0.1; the JAX
references are computed once per module (fixtures); torch runs on one
thread.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_bf16 import (  # noqa: E402
    BF,
    RESO,
    ULP,
    _flax_dtypes,
    bf16,
    inputs,
    n,
    net_cfg,
    params,  # noqa: F401 (a module fixture)
    t,
)
from test_torch_cuda import sorted_batch, tile_batch  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops import sorted_scatter as jss  # noqa: E402
from tomosar2height_tpu.ops.pallas import fused as jfused  # noqa: E402
from tomosar2height_tpu.ops.pallas.gather_kernel import pallas_tile_gather  # noqa: E402
from tomosar2height_tpu.ops.pallas.pool_kernel import pallas_tile_pool  # noqa: E402
from tomosar2height_tpu.ops.pallas.scatter_kernel import (  # noqa: E402
    pallas_aligned_scatter_mean_plane,
    pallas_scatter_mean,
    pallas_scatter_mean_plane,
    pallas_scatter_mean_plane_v3,
)
from tomosar2height_tpu.ops.sampling import grid_sample_2d as jax_grid_sample  # noqa: E402
from tomosar2height_tpu.ops.scatter import segment_max as jax_segment_max  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.ops import fused  # noqa: E402
from tomosar2height_tpu_torch.ops import sorted_scatter as ss  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk  # noqa: E402
from tomosar2height_tpu_torch.ops.scatter import segment_max  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import (  # noqa: E402
    host_morton_bucket,
    host_morton_bucket_aligned,
)
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    load_flax_params,
    state_dict_to_flax,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the test run shares the cores among its workers."""
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(k)


def ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of want (2^-7 of the power of
    two at or below |want|), the ulp floored at 2^-16 of want's scale, where
    a sum cancels and two f32 orders leave more than an ulp of it."""
    g, w = n(got).astype(np.float64), n(want).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    return float((np.abs(g - w) / np.maximum(ulp, 2.0 ** -16 * np.abs(w).max())).max())


def within_jax_gate(got, jax16, jax32) -> float:
    """JAX's bf16 rule: ``got`` no further from the f32 vjp than max(1.5 x
    JAX's bf16 vjp's distance, 0.02 x scale), nor from JAX's bf16 vjp.
    Returns got's distance from the f32 vjp."""
    r = n(jax32)
    bound = max(1.5 * np.abs(n(jax16) - r).max(), 0.02 * (np.abs(r).max() + 1e-6))
    far = np.abs(n(got) - r).max()
    assert far <= bound, (far, bound)
    assert np.abs(n(got) - n(jax16)).max() <= bound
    return far


def _chunked(cells):
    return jnp.asarray(cells.reshape(cells.shape[0], -1, 128))


def _level(reso: int, finest: int) -> int:
    return finest.bit_length() - reso.bit_length()


def _ties(vals, mask, seed: int = 4):
    """The valid rows' values drawn from {0, 1, 2}: most cells tie in their max."""
    draw = np.random.default_rng(seed).integers(0, 3, vals.shape)
    return np.where(mask[..., None], draw, vals).astype(np.float32)


# -- the kernels, forward -----------------------------------------------------------

@pytest.mark.parametrize("reso,finest,edge", [(32, 64, "empty"), (32, 32, "border")])
def test_tile_gather_matches_jax(reso, finest, edge):
    """K9: the weights cut to bf16, the f32 sum rounded once, bf16 out."""
    pts, mask, _, toff, _ = tile_batch(5, n=800, reso=finest, edge=edge)
    plane = bf16(np.random.default_rng(13).normal(size=(2, reso, reso, 24)))
    lvl = toff[:, :: 4 ** _level(reso, finest)]
    ax, ay = jfused.make_aux(jnp.asarray(pts[..., :2]))
    want = pallas_tile_gather(plane, ax, ay, jnp.asarray(lvl), reso, interpret=True)
    got = gk.tile_gather(t(plane), t(pts[..., :2]), t(lvl))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert ulps(n(got)[mask], n(want)[mask]) <= 1


@pytest.mark.parametrize("kind", ["max", "mean"])
@pytest.mark.parametrize("edge", ["ties", "one_cell"])
def test_tile_pool_matches_jax(kind, edge):
    """K10: max exact, mean within one bf16 ulp; ties, and one cell of ~800
    rows (entry 0)."""
    _, mask, cells, toff, vals = tile_batch(41, n=900, reso=64, f=24,
                                            edge="one_cell" if edge == "one_cell" else "none")
    if edge == "ties":
        vals = _ties(vals, mask)
    vals[~mask] = -1e9 if kind == "max" else 1e9  # junk on the pad rows must not leak
    v = bf16(vals)
    want = pallas_tile_pool(v, _chunked(cells), jnp.asarray(toff), kind, interpret=True)
    got = tpk.tile_pool(t(v), t(cells), t(toff), kind)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    if kind == "max":
        np.testing.assert_array_equal(n(got)[mask], n(want)[mask])
    else:
        assert ulps(n(got)[mask], n(want)[mask]) <= 1
    assert (n(got)[~mask] == 0).all()
    if edge == "one_cell":
        assert np.bincount(cells[0][mask[0]]).max() > 256


@pytest.mark.parametrize("reso,f,one_cell", [(32, 8, False), (16, 4, True)])
def test_sorted_scatter_means_match_jax(reso, f, one_cell):
    """K11 (row-major plane) and K13 (Morton cell vector) on the plain sorted
    layout: within one bf16 ulp; one cell of 900 rows."""
    vals, cells, offs = sorted_batch(3, reso=reso, f=f, one_cell=one_cell)
    v = bf16(vals)
    args = (v, jnp.asarray(cells), jnp.asarray(offs), reso)
    want_plane = pallas_scatter_mean_plane(*args, interpret=True)
    want_vec = pallas_scatter_mean(*args, interpret=True)
    got_plane = sk.scatter_mean_plane(t(v), t(cells), t(offs), reso)
    got_vec = sk.scatter_mean(t(v), t(cells), t(offs), reso)
    assert got_plane.dtype == got_vec.dtype == BF
    assert want_plane.dtype == want_vec.dtype == jnp.bfloat16
    assert ulps(got_plane, want_plane) <= 1 and ulps(got_vec, want_vec) <= 1


@pytest.mark.parametrize("reso,finest,edge", [
    (64, 64, "none"), (32, 64, "none"), (16, 64, "one_cell"), (32, 32, "empty")])
def test_aligned_scatter_means_match_jax(reso, finest, edge):
    """K12 (tile offsets at this resolution) and K14 (the finest ones; >= 32^2)
    within one bf16 ulp, K12's counts those of the layout; at 16^2 one cell
    of ~800 rows."""
    _, mask, cells, toff, vals = tile_batch(7, n=900, reso=finest, edge=edge)
    v = bf16(vals)
    lvl = toff[:, :: 4 ** _level(reso, finest)]
    want = pallas_aligned_scatter_mean_plane(v, _chunked(cells), jnp.asarray(lvl), reso,
                                             finest, interpret=True)
    got, counts = sk.aligned_scatter_mean_plane(t(v), t(cells), t(lvl), reso, finest,
                                                with_counts=True)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert ulps(got, want) <= 1
    shift = 2 * _level(reso, finest)
    want_counts = np.zeros((2, reso, reso), np.int64)
    for b in range(2):
        c = cells[b][mask[b]] >> shift
        x = sum(((c >> (2 * k)) & 1) << k for k in range(reso.bit_length() - 1))
        y = sum(((c >> (2 * k + 1)) & 1) << k for k in range(reso.bit_length() - 1))
        np.add.at(want_counts[b], (y, x), 1)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    if reso >= 32:
        want3 = pallas_scatter_mean_plane_v3(v, _chunked(cells), jnp.asarray(toff), reso,
                                             finest, interpret=True)
        got3 = sk.scatter_mean_plane_v3(t(v), t(cells), t(toff), reso, finest)
        assert got3.dtype == BF and want3.dtype == jnp.bfloat16
        assert ulps(got3, want3) <= 1
    if edge == "one_cell":
        assert counts.max() > 256


# -- the backwards --------------------------------------------------------------------

@pytest.mark.parametrize("reso,finest", [(32, 32), (32, 64)])
def test_tile_gather_bwd_within_jax_gate(reso, finest):
    """K9's backward: the transpose of the cut weights at the f32
    coordinates (the port) against JAX's, which samples at coordinates
    rounded to bf16: both within JAX's gate of the f32 vjp; the port far
    inside it."""
    pts, mask, cells, toff, _ = tile_batch(21, n=600, reso=finest)
    lvl = toff[:, :: 4 ** _level(reso, finest)]
    rng = np.random.default_rng(reso + finest)
    plane = bf16(rng.normal(size=(2, reso, reso, 16)))
    cot = bf16(rng.normal(size=mask.shape + (16,)))
    ax, ay = jfused.make_aux(jnp.asarray(pts[..., :2]))
    # the custom_vjp's backward itself (its forward, the kernel, is held above)
    jax_vjp = jax.jit(lambda p, g: jfused._tile_gather_bwd(
        reso, (p, ax, ay, jnp.asarray(mask)), g)[0])
    want16 = jax_vjp(plane, cot)
    want32 = jax_vjp(plane.astype(jnp.float32), cot.astype(jnp.float32))
    p = t(plane).requires_grad_()
    fused.tile_gather(p, t(pts[..., :2]), t(mask), t(cells), t(lvl), reso,
                      finest).backward(t(cot))
    assert p.grad.dtype == BF and want16.dtype == jnp.bfloat16
    far = within_jax_gate(p.grad, want16, want32)
    assert far <= 0.1 * np.abs(n(want16) - n(want32)).max()  # measured 0.024-0.029


@pytest.mark.parametrize("kind,edge", [("max", "ties"), ("max", "one_cell"),
                                       ("mean", "none"), ("mean", "one_cell")])
def test_tile_pool_bwd_matches_jax(kind, edge):
    """K10's backward (max: each run's f32 cotangent sum split among its
    tied rows, rounded once; mean: the f32 run mean of g): within one bf16
    ulp of JAX's f32 vjp on the same bf16 values, and within JAX's gate of
    its bf16 vjp, which sums in bf16."""
    _, mask, cells, toff, vals = tile_batch(43, n=900, reso=64, f=8,
                                            edge="one_cell" if edge == "one_cell" else "none")
    if edge == "ties":
        vals = _ties(vals, mask, 9)
    vals[~mask] = 0.0
    v16 = bf16(vals)
    cot = bf16(np.random.default_rng(5).normal(size=vals.shape))

    jax_vjp = jax.jit(lambda v, g: jfused._tile_pool_bwd(
        64, kind, (v, _chunked(cells), jnp.asarray(mask)), g)[0])
    want16 = jax_vjp(v16, cot)
    want32 = jax_vjp(v16.astype(jnp.float32), cot.astype(jnp.float32))
    v = t(v16).requires_grad_()
    fused.tile_pool(v, t(cells), t(toff), t(mask), 64, kind).backward(t(cot))
    assert v.grad.dtype == BF and want16.dtype == jnp.bfloat16
    assert ulps(v.grad, want32) <= 1
    within_jax_gate(v.grad, want16, want32)


@pytest.mark.parametrize("reso,finest,edge", [(32, 32, "none"), (16, 64, "one_cell")])
def test_tile_scatter_bwd_matches_jax(reso, finest, edge):
    """K12's backward: the bf16 cotangent over the count cast to bf16 (a
    count above 256 rounds), as JAX's: equal, bit for bit."""
    _, mask, cells, toff, vals = tile_batch(31, n=900, reso=finest, f=8, edge=edge)
    vals[~mask] = 0.0
    lvl = toff[:, :: 4 ** _level(reso, finest)]
    g = bf16(np.random.default_rng(33).normal(size=(2, reso, reso, 8)))
    want = jax.jit(lambda c, g: jfused._tile_scatter_bwd(reso, finest, c, g)[0])(
        _chunked(cells), g)
    v = t(bf16(vals)).requires_grad_()
    plane = fused.tile_scatter_mean(v, t(cells), t(lvl), reso, finest)
    plane.backward(t(g))
    assert plane.dtype == v.grad.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(n(v.grad), n(want))
    assert (n(v.grad)[~mask] == 0).all()
    if edge == "one_cell":  # the rule shows: the exact count gives other bits
        _, counts = sk.aligned_scatter_mean_plane(v.detach(), t(cells), t(lvl), reso, finest,
                                                  with_counts=True)
        assert counts.max() > 256 and float(counts.max()) != float(counts.max().to(BF))
        exact = sk.aligned_scatter_mean_plane_bwd_plain(t(g).float(), t(cells), counts, reso,
                                                        finest).to(BF)
        assert not torch.equal(exact, v.grad)


@pytest.fixture(scope="module")
def plain_sorted():
    """Two patches of 1500 points on the plain sorted layout at 64^2."""
    rng = np.random.default_rng(17)
    pts = rng.uniform(0.001, 0.999, (2, 1500, 3)).astype(np.float32)
    mask = rng.random((2, 1500)) > 0.05
    rows = [host_morton_bucket(pts[i], mask[i], 64) for i in range(2)]
    return {"xy": np.stack([pts[i][o][:, :2] for i, (o, _, _) in enumerate(rows)]),
            "mask": np.stack([mask[i][o] for i, (o, _, _) in enumerate(rows)]),
            "cells": np.stack([c for _, c, _ in rows]),
            "offsets": np.stack([o for _, _, o in rows])}


@pytest.mark.parametrize("reso", [64, 16])
def test_sorted_sample_bwd_matches_jax(plain_sorted, reso):
    """``cumsum``'s (and ``pallas``'s, ``fused``'s below 32^2) sample of a
    bf16 plane: f32 out, as JAX promotes it; its backward from an f32
    cotangent, each pixel's f32 sum with the uncut weights rounded to bf16
    once (K5's d_plane pass from f32 into bf16): within one bf16 ulp of
    JAX's f32 vjp, and within JAX's gate of its bf16 vjp, which rounds each
    row's contribution to bf16 and adds in bf16."""
    d = plain_sorted
    rng = np.random.default_rng(reso)
    plane = bf16(rng.normal(size=(2, reso, reso, 8)))
    cot = (rng.normal(size=d["mask"].shape + (8,)) * d["mask"][..., None]).astype(np.float32)
    xy = jnp.asarray(d["xy"])
    out16, vjp = jax.vjp(lambda p: jax_grid_sample(p, xy), plane)
    want16 = vjp(jnp.asarray(cot))[0]
    _, vjp32 = jax.vjp(lambda p: jax_grid_sample(p, xy), plane.astype(jnp.float32))
    want32 = vjp32(jnp.asarray(cot))[0]
    p = t(plane).requires_grad_()
    out = fused.sorted_sample(p, t(d["xy"]), t(d["mask"]), t(d["cells"]), 64)
    out.backward(t(cot))
    assert out.dtype == torch.float32 and out16.dtype == jnp.float32
    assert ulps(out, out16) <= 1
    assert p.grad.dtype == BF and want16.dtype == jnp.bfloat16
    assert ulps(p.grad, want32) <= 1
    within_jax_gate(p.grad, want16, want32)


@pytest.mark.parametrize("reso", [64, 32])
def test_cumsum_ops_match_jax(plain_sorted, reso):
    """``cumsum``'s scatter-mean in bf16 (the float64 running sums rounded
    once, counts cast to bf16, the mean divided in bf16; JAX sums in f32)
    within one bf16 ulp, its backward too; the max pooling
    (``segment_max`` exact, its gather-back) as K10's backward: within one
    bf16 ulp of JAX's f32 vjp, and within JAX's gate of its bf16 vjp, ties
    included."""
    d = plain_sorted
    lvl = _level(reso, 64)
    off, cells = d["offsets"][:, :: 4 ** lvl], d["cells"] >> (2 * lvl)
    rng = np.random.default_rng(reso + 1)
    vals = (rng.normal(size=d["mask"].shape + (8,)) * d["mask"][..., None]).astype(np.float32)
    g = bf16(rng.normal(size=(2, reso, reso, 8)))
    out16, vjp = jax.vjp(lambda v: jss.scatter_mean_plane_morton(
        v, jnp.asarray(off), jnp.asarray(cells), reso, "cumsum"), bf16(vals))
    want = vjp(g)[0]
    v = t(bf16(vals)).requires_grad_()
    out = ss.scatter_mean_plane_morton(v, t(off), t(cells), reso, "cumsum")
    out.backward(t(g))
    assert out.dtype == v.grad.dtype == BF and out16.dtype == want.dtype == jnp.bfloat16
    assert ulps(out, out16) <= 1 and ulps(v.grad, want) <= 1

    def jax_pool(x):
        pooled = jax_segment_max(x, jnp.asarray(cells), reso * reso, jnp.asarray(d["mask"]))
        return jss.gather_cells_sorted(pooled, jnp.asarray(cells))

    cot = bf16(rng.normal(size=vals.shape))
    for x in (vals, _ties(vals, d["mask"])):
        x16 = bf16(x)
        out16, vjp = jax.vjp(jax_pool, x16)
        want16 = vjp(cot)[0]
        want32 = jax.vjp(jax_pool, x16.astype(jnp.float32))[1](cot.astype(jnp.float32))[0]
        v = t(x16).requires_grad_()
        out = ss.gather_sorted_rows(segment_max(v, t(cells), reso * reso, t(d["mask"])),
                                    t(cells), t(off))
        out.backward(t(cot))
        np.testing.assert_array_equal(n(out), n(out16))
        assert v.grad.dtype == BF and ulps(v.grad, want32) <= 1
        within_jax_gate(v.grad, want16, want32)


# -- the network ------------------------------------------------------------------------

def cfg(dtype: str, impl=None) -> dict:
    """``net_cfg`` on the sorted layout ``impl`` (None: unsorted)."""
    c = net_cfg(dtype, sort=impl is not None)
    if impl is not None:
        c["model"]["encoder_kwargs"]["sorted_impl"] = impl
    return c


def layout(x: dict, impl: str) -> dict:
    """inputs() as the loader ships them for ``impl``: the aligned layout of
    256-cell tiles (``fused``) or the plain sorted one (points, mask, finest
    cells, tile or per-cell offsets)."""
    pts, mask = x["points"], x["point_mask"]
    if impl == "fused":
        rows = [host_morton_bucket_aligned(pts[i], mask[i], RESO, tile_cells=256)
                for i in range(len(pts))]
        return {k: np.stack([r[k] for r in rows])
                for k in ("points", "mask", "cells", "tile_offsets")}
    rows = [host_morton_bucket(pts[i], mask[i], RESO) for i in range(len(pts))]
    return {"points": np.stack([pts[i][o] for i, (o, _, _) in enumerate(rows)]),
            "mask": np.stack([mask[i][o] for i, (o, _, _) in enumerate(rows)]),
            "cells": np.stack([c for _, c, _ in rows]),
            "tile_offsets": np.stack([o for _, _, o in rows])}


def model_args(impl=None, seed: int = 0) -> tuple:
    x = inputs(seed)
    if impl is None:
        return x["points"], x["point_mask"], x["image"]
    a = layout(x, impl)
    return a["points"], a["mask"], x["image"], a["cells"], a["tile_offsets"]


def jax_apply(params, dtype: str, impl=None, capture: bool = False):
    model = jax_build_model(cfg(dtype, impl))
    kw = {"capture_intermediates": True, "mutable": ["intermediates"]} if capture else {}
    return jax.jit(lambda p, *a: model.apply(p, *a, **kw))(
        params, *map(jnp.asarray, model_args(impl)))


def port_model(params, impl: str):
    return load_flax_params(build_model(cfg("bfloat16", impl), device="cpu"),
                            jax.tree.map(np.asarray, params)).eval()


@pytest.fixture(scope="module")
def served(params):
    """JAX's f32 heights (unsorted), its bf16 heights on ``fused`` and
    ``cumsum`` (with their captured intermediates), and the port's bf16
    heights on ``fused``, ``cumsum`` and ``pallas``."""
    out = {"f32": n(jax_apply(params, "float32")[0][..., 0])}
    for impl in ("fused", "cumsum"):
        (h, _), state = jax_apply(params, "bfloat16", impl, capture=True)
        out[f"jax {impl}"] = n(h[..., 0])
        out[f"dtypes {impl}"] = _flax_dtypes(state["intermediates"])
    for impl in ("fused", "cumsum", "pallas"):
        with torch.no_grad():
            pa, pb = port_model(params, impl)(*(t(a) for a in model_args(impl)))
        assert pa.dtype == torch.float32 and pb is None
        out[impl] = pa[..., 0].numpy()
    return out


@pytest.mark.parametrize("impl,floor", [("fused", "fused"), ("cumsum", "cumsum"),
                                        ("pallas", "cumsum")])
def test_served_heights_within_jax_floor(served, impl, floor):
    """The port's bf16 heights on ``impl`` no further from JAX's f32 heights
    than 2x JAX's bf16 heights on ``floor``'s layout (``pallas``: JAX's
    ``cumsum``, the same function on the same layout), max and mean |d|;
    and JAX's gate."""
    ref, mine = served["f32"], served[impl]
    scale = max(np.abs(ref).max(), 1.0)
    base, d = np.abs(served[f"jax {floor}"] - ref), np.abs(mine - ref)
    assert base.max() > 0  # bf16 moved JAX's heights: the floor is real
    assert d.max() <= 2 * base.max(), (d.max(), base.max())
    assert d.mean() <= 2 * base.mean(), (d.mean(), base.mean())
    assert d.max() / scale < 0.15
    assert np.corrcoef(ref.ravel(), mine.ravel())[0, 1] > 0.99


@pytest.mark.parametrize("impl", ["fused", "cumsum"])
def test_dtype_map_matches_flax(params, served, impl):
    """Every module's output dtypes equal its flax module's on the layout."""
    want = served[f"dtypes {impl}"]
    port = port_model(params, impl)
    got = {}

    def hook(name):
        def record(module, args, output):
            leaves = output.values() if isinstance(output, dict) else (
                output if isinstance(output, tuple) else (output,))
            got[name] = [str(o.dtype).replace("torch.", "") for o in leaves if o is not None]
        return record

    handles = [m.register_forward_hook(hook(tuple(k.split(".")) if k else ()))
               for k, m in port.named_modules()]
    with torch.no_grad():
        port(*(t(a) for a in model_args(impl)))
    for h in handles:
        h.remove()
    both = sorted(set(got) & set(want))
    assert len(both) >= 60, len(both)
    mismatched = {k: (got[k], want[k]) for k in both if got[k] != want[k]}
    assert not mismatched, mismatched


def _batch(impl=None) -> dict:
    x = inputs(1)
    if impl is None:
        return x
    a = layout(x, impl)
    return {**x, "points": a["points"], "point_mask": a["mask"], "cell": a["cells"],
            "cell_offsets": a["tile_offsets"]}


TRAIN = {"optimize_every": 2, "wire_dsm_dtype": "float32"}


@pytest.fixture(scope="module")
def steps(params):
    """JAX's f32 (plain) L1 step, its bf16 steps on ``fused`` and ``cumsum``,
    and the port's bf16 steps on both (loss_l1, gradients), from the same
    weights on the same patches."""
    out = {}
    for name, dt, impl in (("f32", "float32", None), ("jax fused", "bfloat16", "fused"),
                           ("jax cumsum", "bfloat16", "cumsum")):
        jt = JaxTrainer(jax_build_model(cfg(dt, impl)), TRAIN, use_cloud=True, use_image=True,
                        use_footprint=False, mesh=make_mesh(1), donate=False)
        (_, m), g = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
            params, jt.prepare_batch(_batch(impl)))
        out[name] = float(m["loss_l1"]), jax.tree.map(np.asarray, g)
    for impl in ("fused", "cumsum"):
        trainer = Trainer(port_model(params, impl), TRAIN, use_image=True)
        loss, metrics = trainer.loss(trainer.prepare_batch(_batch(impl)))
        grads = torch.autograd.grad(loss, trainer.params)
        assert all(g.dtype == torch.float32 for g in grads)
        names = [k for k, _ in trainer.model.named_parameters()]
        out[impl] = float(metrics["loss_l1"].detach()), state_dict_to_flax(
            dict(zip(names, grads)))
    return out


@pytest.mark.parametrize("impl", ["fused", "cumsum"])
def test_step_loss_within_jax_floor(steps, impl):
    ref, jb, mine = steps["f32"][0], steps[f"jax {impl}"][0], steps[impl][0]
    assert abs(mine - ref) <= 2 * abs(jb - ref), (mine, jb, ref)


@pytest.mark.parametrize("impl", ["fused", "cumsum"])
def test_step_gradients_within_jax_floor(steps, impl):
    """Each tensor's |g_port - g_f32| / |g_f32| within 2x JAX's bf16 step's
    on the same layout (or 2^-8), and so over all tensors."""
    ref = jax.tree_util.tree_flatten_with_path(steps["f32"][1])[0]
    jb = jax.tree.leaves(steps[f"jax {impl}"][1])
    mine = jax.tree.leaves(steps[impl][1])
    assert len(ref) == len(jb) == len(mine)
    bad, num, floor = [], 0.0, 0.0
    for (path, r), a, m in zip(ref, jb, mine):
        norm = max(np.linalg.norm(r), 1e-30)
        rel_j, rel_m = np.linalg.norm(a - r) / norm, np.linalg.norm(m - r) / norm
        if rel_m > max(2 * rel_j, ULP):
            bad.append((jax.tree_util.keystr(path), rel_m, rel_j))
        num += np.sum((m - r) ** 2)
        floor += np.sum((a - r) ** 2)
    assert not bad, bad
    assert np.sqrt(num) <= 2 * np.sqrt(floor)


def test_pallas_does_not_train_in_bf16(params):
    """``pallas`` stays forward-only in bf16: the Trainer's step raises, and
    ``cli.train`` refuses the layout whatever the dtype."""
    from tomosar2height_tpu_torch.cli import train as cli_train

    trainer = Trainer(port_model(params, "pallas"), TRAIN, use_image=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        trainer.train_step(_batch("pallas"), 1e-3)
    with pytest.raises(NotImplementedError, match="no gradient either"):
        cli_train.run(["dataset=synthetic", "device.platform=cpu", "model.dtype=bfloat16",
                       "dataset.points.sort=true", "model.encoder_kwargs.sorted_impl=pallas"])
