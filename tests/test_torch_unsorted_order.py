"""The unsorted point path's plain ops in a fixed order (``ops/scatter.py``:
``fixed_order``, ``index_add_rows``, ``gather_cells``), on the CPU.

- The segment sums, means and counts, ``gather_cells``' backward,
  ``grid_sample_2d`` forward and backward and ``grid_sample_2d_adjoint``,
  in float32 and bf16, with masked rows and empty cells: bit-equal to the
  plain ops they replace (``index_add_`` and the autograd of
  ``torch.gather``, both in row order on the CPU); with a mask, the gathers'
  backwards leave the masked rows' cotangents out, which is the same sum
  where those are zeros, as in the model.
- torch's deterministic mode: on inside each op, in its forward and in its
  backward, and as it was after a forward, after a backward and after an
  exception, ``warn_only`` included.
- The unsorted network (cloud only, plane 32, depth 2, widths 8): its
  heights and one training step's gradients bit-equal to those of the
  replaced ops, in float32 and bf16; and in float32 against the JAX
  package's unsorted path at the JAX package's tolerances (heights 2e-4 x
  z_scale, tests/test_fused_model.py:73; the step's gradients, the port in
  float64, 2e-4 x max|g| + 2e-4 rel, as tests/test_torch_train.py holds
  them). The bf16 network is held to JAX's bf16 gate by
  tests/test_torch_bf16.py, on the same ops.

Torch runs on one thread here.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.ops import sampling, scatter  # noqa: E402
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    flatten_tree,
    load_flax_params,
    state_dict_to_flax,
)

BF = torch.bfloat16
DTYPES = [torch.float32, BF]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the ops they replace, as they were ----------------------------------------------

def old_index_add(out, index, rows):
    return out.index_add_(0, index, rows)


def old_gather_cells(src, index, mask=None):
    idx = index.long()[..., None].expand(*index.shape, src.shape[-1])
    return torch.gather(src, 1, idx)


@pytest.fixture()
def replaced_ops(monkeypatch):
    """Puts the plain ops back where the fixed-order ones are used."""
    def put_back():
        for mod in (scatter, sampling):
            monkeypatch.setattr(mod, "index_add_rows", old_index_add)
            monkeypatch.setattr(mod, "gather_cells", old_gather_cells)
    return put_back


def _segments(seed: int, dtype, b=3, n=257, c=12, reso=8):
    """Values, cell ids over reso**2 cells of which some stay empty (ids
    drawn from half the cells), masked rows, and a cotangent."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.normal(0, 1, (b, n, c)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, reso * reso // 2, (b, n)) * 2)
    mask = torch.from_numpy(rng.random((b, n)) > 0.2)
    mask[-1] = False  # a batch entry with no valid row: every cell empty
    g = torch.from_numpy(rng.normal(0, 1, (b, reso * reso, c)).astype(np.float32)).to(dtype)
    return vals, idx, mask, g, reso


def _both(replaced_ops, fn):
    """fn() with the fixed-order ops, then with the replaced ones."""
    new = fn()
    replaced_ops()
    return new, fn()


def _equal(a, b):
    a, b = (a if isinstance(a, (tuple, list)) else (a,)), (b if isinstance(b, (tuple, list))
                                                          else (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), float((x.double() - y.double()).abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["sum", "mean", "counts"])
def test_segment_reductions_bit_equal(replaced_ops, op, dtype):
    vals, idx, mask, g, reso = _segments(1, dtype)
    ncell = reso * reso

    def run():
        if op == "counts":
            return scatter.segment_counts(idx, ncell, mask)
        v = vals.clone().requires_grad_()
        fn = scatter.segment_sum if op == "sum" else scatter.segment_mean
        out = fn(v, idx, ncell, mask)
        (dv,) = torch.autograd.grad(out, v, g)
        return out.detach(), dv

    new, old = _both(replaced_ops, run)
    _equal(new, old)
    out = new if op == "counts" else new[0]
    assert (out[-1] == 0).all()  # the batch entry with no valid row


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_cells_backward_bit_equal(replaced_ops, dtype, masked):
    """Every row's cotangent added back; with the mask, the valid rows'
    only, which is the same sum where the masked rows' cotangents are zeros
    (as in the model, where masked rows reach nothing)."""
    vals, idx, mask, _, reso = _segments(2, dtype)
    planes = torch.randn(vals.shape[0], reso * reso, vals.shape[-1],
                         generator=torch.Generator().manual_seed(2)).to(dtype)
    g = torch.where(mask[..., None], vals, torch.zeros_like(vals)) if masked else vals

    def run():
        p = planes.clone().requires_grad_()
        out = scatter.gather_cells(p, idx, mask if masked else None)
        (dp,) = torch.autograd.grad(out, p, g)
        return out.detach(), dp

    new, old = _both(replaced_ops, run)
    _equal(new, old)
    assert (new[1].reshape(-1, new[1].shape[-1])[1::2] == 0).all()  # cells no row reads


def test_masked_rows_take_no_part_in_the_backward():
    """With a mask, a masked row's cotangent is not added back: the
    gradient is the one of the valid rows alone, in f32 and bf16."""
    for dtype in DTYPES:
        vals, idx, mask, _, reso = _segments(6, dtype)
        planes = torch.zeros(vals.shape[0], reso * reso, vals.shape[-1], dtype=dtype,
                             requires_grad=True)
        (got,) = torch.autograd.grad(scatter.gather_cells(planes, idx, mask), planes, vals)
        (want,) = torch.autograd.grad(
            scatter.gather_cells(planes, idx), planes,
            torch.where(mask[..., None], vals, torch.zeros_like(vals)))
        (every,) = torch.autograd.grad(scatter.gather_cells(planes, idx), planes, vals)
        _equal(got, want)
        assert not torch.equal(got, every)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_local_max_bit_equal(replaced_ops, dtype):
    """segment_max (order-free) and the fixed-order gather-back, forward and
    backward, with ties (values rounded to a coarse grid)."""
    vals, idx, mask, _, reso = _segments(3, dtype)
    vals = (vals * 2).round() / 2
    gout = torch.randn(vals.shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    gout = torch.where(mask[..., None], gout, torch.zeros_like(gout))  # masked rows: zeros

    def run():
        v = vals.clone().requires_grad_()
        out = scatter.pool_local_max(v, idx, reso, mask)
        (dv,) = torch.autograd.grad(out, v, gout)
        return out.detach(), dv

    new, old = _both(replaced_ops, run)
    _equal(new, old)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_sample_bit_equal(replaced_ops, dtype, masked):
    """The sample and its backward (the gathers' adjoint; with a mask, over
    the valid rows, their cotangents zeros at the masked rows), and the
    explicit adjoint, cut and uncut; points on the border and past it
    (clamped)."""
    rng = np.random.default_rng(4)
    b, h, w, c, n = 2, 9, 7, 10, 300
    plane = torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).to(dtype)
    xy = torch.from_numpy(rng.uniform(-0.05, 1.05, (b, n, 2)).astype(np.float32))
    xy[:, :8] = torch.tensor([0.0, 1.0]).repeat(4)[:8].reshape(1, 8, 1)
    g = torch.from_numpy(rng.normal(0, 1, (b, n, c)).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(rng.random((b, n)) > 0.3) if masked else None
    if masked:
        g = torch.where(mask[..., None], g, torch.zeros_like(g))

    def run():
        p = plane.clone().requires_grad_()
        out = sampling.grid_sample_2d(p, xy, mask)
        (dp,) = torch.autograd.grad(out, p, g)
        adj = sampling.grid_sample_2d_adjoint(g.float(), xy, h, w)
        cut = sampling.grid_sample_2d_adjoint(g.float(), xy, h, w, cut=BF)
        return out.detach(), dp, adj, cut

    new, old = _both(replaced_ops, run)
    _equal(new, old)


# -- the mode ----------------------------------------------------------------------

def _mode():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)


@pytest.fixture()
def mode_spy(monkeypatch):
    """Records the mode inside every index_add_ and scatter_add_ (which
    autograd's backward of a plain gather would run)."""
    seen = []
    for name in ("index_add_", "scatter_add_"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            seen.append((_name, torch.are_deterministic_algorithms_enabled()))
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    return seen


@pytest.mark.parametrize("before", [(False, False), (True, True)])
def test_mode_on_inside_and_restored(mode_spy, before):
    """On in the forward's adds and in the backward's, and as it was
    before after each (also when it was on with warn_only, as
    tools/c1_sources.py sets it)."""
    vals, idx, mask, g, reso = _segments(5, torch.float32, b=2, n=50, c=4, reso=4)
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    try:
        start = _mode()
        v = vals.clone().requires_grad_()
        out = scatter.pool_local_mean(v, idx, reso, mask)
        assert _mode() == start
        fwd = list(mode_spy)
        out.backward(torch.ones_like(out))
        assert _mode() == start
        bwd = mode_spy[len(fwd):]
    finally:
        torch.use_deterministic_algorithms(False)
    assert {n for n, _ in fwd} == {"index_add_"} and all(on for _, on in fwd)
    assert {n for n, _ in bwd} == {"index_add_"} and all(on for _, on in bwd)


def test_mode_restored_after_an_exception():
    start = _mode()
    with pytest.raises(RuntimeError):
        # rows of another width than the output's: index_add_ raises inside
        scatter.index_add_rows(torch.zeros(4, 3), torch.tensor([0, 1]), torch.ones(2, 5))
    assert _mode() == start

    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with scatter.fixed_order():
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.utils.deterministic.fill_uninitialized_memory
            raise Boom()
    assert _mode() == start


def test_mode_restored_after_a_failing_backward():
    """A cotangent of the wrong shape makes the gather's backward raise
    inside the fixed-order scope."""
    p = torch.randn(2, 6, 3, requires_grad=True)
    out = scatter.gather_cells(p, torch.tensor([[0, 5], [1, 1]]))
    start = _mode()
    with pytest.raises(RuntimeError):
        scatter._GatherRows.backward(type("Ctx", (), {
            "saved_tensors": (torch.zeros(2, 2, dtype=torch.long), None),
            "shape": (2, 6, 3)})(), torch.ones(2, 2, 4))
    assert _mode() == start
    out.sum().backward()
    assert _mode() == start


# -- the network ----------------------------------------------------------------------

RESO, N, B, OUT = 32, 400, 2, 64
Z_SCALE = 60.0


def net_cfg(dtype: str = "float32") -> dict:
    """The flagship network cut to CPU size on the unsorted path."""
    return {
        "use_cloud": True, "use_image": False,
        "dataset": {"normalize": {"z_bound": [0.0, Z_SCALE]}, "points": {"sort": False}},
        "model": {
            "encoder": "pointnet_local_pool", "dtype": dtype, "remat": True,
            "encoder_kwargs": {
                "hidden_dim": 8, "feature_dim": 8, "plane_resolution": RESO,
                "scatter_type": "max", "sorted_impl": "fused2", "unet_type": "alto",
                "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 8}},
            "decoder_pixel_kwargs": {
                "mode": "conv", "use_footprint": False, "hidden_dim": 8, "out_dim": 1,
                "output_size": OUT, "sample_mode": "bilinear", "leaky": False}}}


def batch(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"points": rng.uniform(0.001, 0.999, (B, N, 3)).astype(np.float32),
            "point_mask": rng.random((B, N)) > 0.05,
            "patch_valid": np.array([True] * B),
            "dsm": rng.uniform(0.0, 30.0, (B, OUT, OUT)).astype(np.float32)}


@pytest.fixture(scope="module")
def params():
    x = batch()
    p = jax.jit(jax_build_model(net_cfg()).init)(
        jax.random.PRNGKey(0), jnp.asarray(x["points"]), jnp.asarray(x["point_mask"]))
    return jax.tree.map(np.asarray, p)


def port_trainer(params, dtype: str = "float32"):
    model = load_flax_params(build_model(net_cfg(dtype), device="cpu"), params)
    return Trainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float32"})


def _heights_and_grads(params, dtype, double=False):
    trainer = port_trainer(params, dtype)
    if double:
        trainer.model.double()
    dev = trainer.prepare_batch(batch(1))
    if double:
        dev["points"] = dev["points"].double()
    with torch.no_grad():
        heights, _ = trainer.model(dev["points"], dev["point_mask"])
    loss, _ = trainer.loss(dev)
    grads = torch.autograd.grad(loss, trainer.params)
    names = [k for k, _ in trainer.model.named_parameters()]
    return heights, loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_network_bit_equal_to_the_replaced_ops(params, replaced_ops, dtype):
    new, old = _both(replaced_ops, lambda: _heights_and_grads(params, dtype))
    _equal(new[:2], old[:2])
    assert sorted(new[2]) == sorted(old[2])
    _equal([new[2][k] for k in sorted(new[2])], [old[2][k] for k in sorted(old[2])])


def test_network_heights_match_jax(params):
    x = batch(1)
    want, _ = jax.jit(jax_build_model(net_cfg()).apply)(
        params, jnp.asarray(x["points"]), jnp.asarray(x["point_mask"]))
    got = _heights_and_grads(params, "float32")[0]
    assert got.shape == (B, OUT, OUT, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4 * Z_SCALE)


def test_network_step_gradients_match_jax(params):
    """The port in float64 (tests/test_torch_train.py says why), JAX in
    float32."""
    jt = JaxTrainer(jax_build_model(net_cfg()), {"optimize_every": 2,
                                                  "wire_dsm_dtype": "float32"},
                    use_cloud=True, mesh=make_mesh(1), donate=False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        params, jt.prepare_batch(batch(1)))
    _, loss, grads = _heights_and_grads(params, "float32", double=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = flatten_tree(state_dict_to_flax(grads)["params"])
    want = flatten_tree(jax.tree.map(np.asarray, jgrads)["params"])
    assert sorted(got) == sorted(want)
    for k in got:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=str(k))
