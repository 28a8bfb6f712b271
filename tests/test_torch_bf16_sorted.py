"""bf16 on the ``fused2`` layout (``model.dtype=bfloat16`` with
``dataset.points.sort=true``): the port against the JAX package on the CPU,
the JAX Pallas kernels in bf16 in interpret mode. The port runs its plain
versions here (CPU tensors); the CUDA kernels are held to them on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

- K1 + K2 (``pool2``) at reso 32, F 8 and 32, on the aligned layout with
  ties: max exact; mean within one bf16 ulp (one f32 mean rounded once, the
  sums in another order); their backwards on the same cotangent the same
  (max: every tied row gets its cell's rounded sum, ties compared in f32).
- K3 (``scatter_plane2``): the plane within one bf16 ulp, the counts
  equal; its backward (``(g / count)`` rounded once, then gathered) within
  one bf16 ulp (JAX multiplies by ``1 / count``, the port divides).
- K4 (``fused_level``) and K5 (its backward: d_plane, d_c_last and the six
  weight gradients) at reso 32, F 8 and 32 (``tests/test_fused_level_bwd.py``
  ``_setup``): each output within JAX's own bf16 rule,
  ``max(1.5 x err(JAX bf16 ref, f32), 0.02 x scale)``
  (tests/test_fused_level_bwd.py:184-190), of the f32 reference and of the
  JAX bf16 kernel; output dtypes equal JAX's.
- The cloud+image network at ``tests/test_bf16.py``'s size on fused2 in
  bf16 (its 16^2 bottom level on the dense fixed-order products): its
  heights no further from JAX's f32 heights than 2x JAX's bf16 fused2
  heights are (max and mean |d|), within 0.1 x scale of JAX's bf16 plain
  heights (tests/test_fused_level.py:291), and JAX's gate (0.15 x scale,
  correlation > 0.99; tests/test_bf16.py:14-39). JAX's f32 references, here
  and in the step, run its unsorted plain path, which its f32 fused2 path
  matches to 2e-4 x z_scale (tests/test_fused_level.py), far below bf16's
  distances, and which compiles in a third of the time.
- A dtype map of every module's output on that config against flax's
  ``capture_intermediates`` of the JAX bf16 fused2 model.
- One L1 ``Trainer`` step on fused2 in bf16 against JAX's f32 step and its
  bf16 fused2 step, under ``tests/test_torch_bf16.py``'s gradient rule.

The weights are flax's init with biases drawn at std 0.1. The JAX
references are computed once per module (fixtures); torch runs on one
thread.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_fused_level_bwd import _grads, _setup  # noqa: E402
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
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops.pallas.level_kernel import (  # noqa: E402
    _level_ref,
    chunk_metadata,
    empty_tile_mask,
    fused_level as jax_fused_level,
    make_cells_row,
)
from tomosar2height_tpu.ops.pallas.pool2_kernel import (  # noqa: E402
    pool2 as jax_pool2,
    scatter_plane2 as jax_scatter_plane2,
)
from tomosar2height_tpu.ops.sorted_scatter import host_morton_bucket_aligned  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk  # noqa: E402
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


def ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps of want (2^-7 of the power of two at or
    below |want|), element by element."""
    g, w = n(got), n(want)
    e = np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
    return np.abs(g - w) / 2.0 ** (e - 7)


# -- K1-K3 ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[8, 32])
def pool_case(request):
    """An aligned batch at reso 32 (one 1024-cell tile) with values that tie
    within their cells (a third of each cell's rows take one value), its
    JAX chunk metadata, and bf16 cotangents."""
    f = request.param
    rng = np.random.default_rng(f)
    b, n_pts = 2, 700
    pts = rng.uniform(0.0, 1.0, (b, n_pts, 3)).astype(np.float32)
    pts[:, :8, :2] = rng.choice([0.0, 1.0, 0.001, 0.999], (b, 8, 2))
    mask = rng.random((b, n_pts)) > 0.1
    rows = [host_morton_bucket_aligned(pts[i], mask[i], RESO) for i in range(b)]
    cells, amask, toff = (np.stack([r[k] for r in rows]) for k in ("cells", "mask",
                                                                 "tile_offsets"))
    npad = cells.shape[1]
    vals = rng.normal(0, 1, (b, npad, f)).astype(np.float32)
    tie = rng.random((b, npad)) < 0.3
    vals = np.where(tie[..., None], np.round(vals), vals).astype(np.float32)
    ct, _ = chunk_metadata(jnp.asarray(toff), npad, RESO, RESO)
    return {"vals": bf16(vals), "cells": cells, "mask": amask,
            "cells_row": make_cells_row(jnp.asarray(cells)), "ct": ct,
            "tmask": empty_tile_mask(jnp.asarray(toff), RESO, RESO),
            "g": bf16(rng.normal(0, 1, (b, npad, f))),
            "g_plane": bf16(rng.normal(0, 1, (b, RESO, RESO, f)))}


@pytest.mark.parametrize("kind", ["max", "mean"])
def test_pool2_matches_jax(pool_case, kind):
    c = pool_case
    mask = jnp.asarray(c["mask"])

    def jax_fn(v):
        return jax_pool2(v, c["cells_row"], c["ct"], mask, 1, kind)

    want, vjp = jax.vjp(jax_fn, c["vals"])
    (want_dv,) = vjp(c["g"])
    v = t(c["vals"]).requires_grad_()
    got = pk.pool2(v, t(c["cells"]), t(c["mask"]), RESO, kind)
    got.backward(t(c["g"]))
    assert got.dtype == v.grad.dtype == BF and want.dtype == want_dv.dtype == jnp.bfloat16
    if kind == "max":
        np.testing.assert_array_equal(n(got), n(want))
        assert (n(v.grad) == n(want_dv)).mean() > 0.99  # rounded cell sums
    else:
        assert ulps(got, want).max() <= 1
    assert ulps(v.grad, want_dv).max() <= 1


def test_scatter_plane2_matches_jax(pool_case):
    c = pool_case
    mask = jnp.asarray(c["mask"])

    def jax_fn(v):
        return jax_scatter_plane2(v, c["cells_row"], c["ct"], c["tmask"], mask, RESO)

    want, vjp = jax.vjp(jax_fn, c["vals"])
    (want_dv,) = vjp(c["g_plane"])
    v = t(c["vals"]).requires_grad_()
    plane, counts = pk.scatter_plane2(v, t(c["cells"]), t(c["mask"]), RESO)
    plane.backward(t(c["g_plane"]))
    assert plane.dtype == v.grad.dtype == BF and want.dtype == want_dv.dtype == jnp.bfloat16
    assert ulps(plane, want).max() <= 1
    assert ulps(v.grad, want_dv).max() <= 1
    _, want_counts = pk.scatter_plane2_plain(t(c["vals"]).float(), t(c["cells"]),
                                             t(c["mask"]), RESO)
    assert torch.equal(counts, want_counts)


# -- K4, K5 -----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[8, 32])
def level_case(request):
    """K4 and K5 at reso 32 in bf16: the JAX bf16 kernel, the JAX bf16 and
    f32 references (``_level_ref`` and its vjp), and the port (plain
    versions), forward and backward, on the same inputs and cotangents."""
    f = request.param
    (plane, c_last, weights, aux, cells_row, ct, pt, tmask, mask, xy, cells, g_p,
     g_c) = _setup(RESO, RESO, f, f, seed=f)
    bf = jnp.bfloat16
    meta = (aux, cells_row, ct, pt, tmask, mask)
    a16 = (plane.astype(bf), c_last.astype(bf), tuple(w.astype(bf) for w in weights))
    g16 = (g_p.astype(bf), g_c.astype(bf))
    jax16 = jax_fused_level(*a16, *meta, RESO, RESO)
    level_ref = jax.jit(lambda *x: _level_ref(*x, RESO, RESO))
    ref = {"16": level_ref(*a16, xy, cells, mask),
           "32": level_ref(plane, c_last, weights, xy, cells, mask)}

    def vjp(impl, *x):  # traced (and so run) with the JAX backward ``impl``
        return jax.jit(lambda *y: _grads(impl, *y, RESO, RESO))(*x)

    grads = {"jax16": vjp("fused", *a16, *meta, *g16), "16": vjp("ref", *a16, *meta, *g16),
             "32": vjp("ref", plane, c_last, weights, *meta, g_p, g_c)}
    leaves = [t(a16[0]).requires_grad_(), t(a16[1]).requires_grad_()]
    leaves += [t(w).requires_grad_() for w in a16[2]]
    po, co, _ = lk.fused_level(leaves[0], leaves[1], tuple(leaves[2:]), t(xy), t(cells),
                               t(mask), RESO, RESO)
    loss = (po * t(g16[0])).sum() + (co * t(g16[1])).sum()
    port = torch.autograd.grad(loss, leaves)
    flat = lambda g: [g[0], g[1], *g[2]]  # noqa: E731
    return {"fwd": ((po, co), jax16, ref["16"], ref["32"]),
            "bwd": (port, flat(grads["jax16"]), flat(grads["16"]), flat(grads["32"]))}


def _within_jax_rule(got, jax16, ref16, ref32):
    """JAX's bf16 rule: got no further from the f32 reference than
    max(1.5 x the JAX bf16 reference's distance, 0.02 x scale)."""
    r = n(ref32)
    bound = max(1.5 * np.abs(n(ref16) - r).max(), 0.02 * (np.abs(r).max() + 1e-6))
    assert np.abs(n(got) - r).max() <= bound, (np.abs(n(got) - r).max(), bound)
    assert np.abs(n(got) - n(jax16)).max() <= bound


def test_fused_level_matches_jax(level_case):
    got, jax16, ref16, ref32 = level_case["fwd"]
    for g, j, a, b in zip(got, jax16, ref16, ref32):
        assert g.dtype == BF and j.dtype == jnp.bfloat16
        _within_jax_rule(g, j, a, b)


def test_fused_level_backward_matches_jax(level_case):
    got, jax16, ref16, ref32 = level_case["bwd"]
    assert len(got) == len(jax16) == 8
    for g, j, a, b in zip(got, jax16, ref16, ref32):
        assert g.dtype == BF and j.dtype == jnp.bfloat16
        _within_jax_rule(g, j, a, b)


# -- the network ------------------------------------------------------------------

def aligned(x: dict) -> dict:
    """inputs() on the aligned layout (1024-cell tiles) as the loader ships
    it: points, mask, finest cells and tile offsets."""
    rows = [host_morton_bucket_aligned(x["points"][i], x["point_mask"][i], RESO)
            for i in range(len(x["points"]))]
    return {k: np.stack([r[k] for r in rows])
            for k in ("points", "mask", "cells", "tile_offsets")}


def jax_apply(params, dtype: str, sort: bool, capture: bool = False):
    x = inputs()
    model = jax_build_model(net_cfg(dtype, sort=sort))
    if sort:
        a = aligned(x)
        args = (a["points"], a["mask"], x["image"], a["cells"], a["tile_offsets"])
    else:
        args = (x["points"], x["point_mask"], x["image"])
    kw = {"capture_intermediates": True, "mutable": ["intermediates"]} if capture else {}
    return jax.jit(lambda p, *a: model.apply(p, *a, **kw))(params, *map(jnp.asarray, args))


def port_model(params, dtype: str = "bfloat16"):
    return load_flax_params(build_model(net_cfg(dtype, sort=True), device="cpu"),
                            jax.tree.map(np.asarray, params)).eval()


def port_args():
    x, a = inputs(), aligned(inputs())
    return tuple(t(v) for v in (a["points"], a["mask"], x["image"], a["cells"],
                                a["tile_offsets"]))


@pytest.fixture(scope="module")
def served(params):
    """JAX's f32, bf16 fused2 (with its captured intermediates) and bf16
    plain heights, and the port's bf16 fused2 heights."""
    f32 = jax_apply(params, "float32", False)[0]
    (jb, _), state = jax_apply(params, "bfloat16", True, capture=True)
    plain = jax_apply(params, "bfloat16", False)[0]
    with torch.no_grad():
        pa, pb = port_model(params)(*port_args())
    assert pa.dtype == torch.float32 and pb is None
    return {"f32": n(f32[..., 0]), "bf16": n(jb[..., 0]), "plain": n(plain[..., 0]),
            "port": pa[..., 0].numpy(), "dtypes": _flax_dtypes(state["intermediates"])}


def test_served_heights_within_jax_floor(served):
    ref, mine = served["f32"], served["port"]
    scale = max(np.abs(ref).max(), 1.0)
    floor, d = np.abs(served["bf16"] - ref), np.abs(mine - ref)
    assert floor.max() > 0  # bf16 moved JAX's heights: the floor is real
    assert d.max() <= 2 * floor.max(), (d.max(), floor.max())
    assert d.mean() <= 2 * floor.mean(), (d.mean(), floor.mean())
    # JAX's gates: bf16 fused2 within 0.1 x scale of bf16 plain
    # (tests/test_fused_level.py:291), and within 0.15 x scale of f32 with
    # correlation > 0.99 (tests/test_bf16.py:14-39)
    plain = served["plain"]
    assert np.abs(mine - plain).max() <= 0.1 * max(np.abs(plain).max(), 1.0)
    assert d.max() / scale < 0.15
    assert np.corrcoef(ref.ravel(), mine.ravel())[0, 1] > 0.99


def test_dtype_map_matches_flax(params, served):
    want = served["dtypes"]
    port = port_model(params)
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
        port(*port_args())
    for h in handles:
        h.remove()
    both = sorted(set(got) & set(want))
    assert len(both) >= 60, len(both)
    mismatched = {k: (got[k], want[k]) for k in both if got[k] != want[k]}
    assert not mismatched, mismatched
    # the ALTO levels' point features come back bf16 from K4 (level_kernel.py:270)
    levels = [k for k in both if k[:3] == ("point_encoder", "unet", "down0")]
    assert levels and got[levels[0]][-1] == "bfloat16"


def _batch():
    x = inputs(1)
    a = aligned(x)
    return {**x, "points": a["points"], "point_mask": a["mask"], "cell": a["cells"],
            "cell_offsets": a["tile_offsets"]}


@pytest.fixture(scope="module")
def steps(params):
    """JAX's f32 (plain) and bf16 fused2 L1 steps (loss_l1, gradients) and
    the port's bf16 one, from the same weights on the same patches."""
    batch = _batch()
    out = {}
    for dt, sort in (("float32", False), ("bfloat16", True)):
        jt = JaxTrainer(jax_build_model(net_cfg(dt, sort=sort)),
                        {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                        use_cloud=True, use_image=True, use_footprint=False,
                        mesh=make_mesh(1), donate=False)
        (_, m), g = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
            params, jt.prepare_batch(batch if sort else inputs(1)))
        out[dt] = float(m["loss_l1"]), jax.tree.map(np.asarray, g)
    trainer = Trainer(port_model(params), {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                      use_image=True)
    loss, metrics = trainer.loss(trainer.prepare_batch(batch))
    grads = torch.autograd.grad(loss, trainer.params)
    assert all(g.dtype == torch.float32 for g in grads)
    names = [k for k, _ in trainer.model.named_parameters()]
    out["port"] = float(metrics["loss_l1"].detach()), state_dict_to_flax(
        dict(zip(names, grads)))
    return out


def test_step_loss_within_jax_floor(steps):
    ref, jb, mine = steps["float32"][0], steps["bfloat16"][0], steps["port"][0]
    assert abs(mine - ref) <= 2 * abs(jb - ref), (mine, jb, ref)


def test_step_gradients_within_jax_floor(steps):
    """Each tensor's |g_port - g_f32| / |g_f32| within 2x JAX's bf16 fused2
    step's (or 2^-8), and so over all tensors."""
    ref = jax.tree_util.tree_flatten_with_path(steps["float32"][1])[0]
    jb = jax.tree.leaves(steps["bfloat16"][1])
    mine = jax.tree.leaves(steps["port"][1])
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
