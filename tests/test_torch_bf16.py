"""bf16 (``model.dtype=bfloat16``): the port against the JAX package on the
CPU.

- K8, K7 and K6 (the port's plain versions, which the CPU runs) in bf16
  against the JAX Pallas kernels in bf16 (interpret mode), at 16-24^2 with
  Cin 3 and 8: each within max(4 x floor, 1e-2) of the f32 oracle, floor the
  JAX bf16 kernel's own distance from it (the rule of
  tests/test_decoder_kernel.py:44-78), and within one bf16 rounding of the
  JAX kernel itself. Their backwards (the f32 composition's, each gradient
  in its input's dtype) against the JAX custom_vjps' on the same cotangent.
- A dtype map: every module's output dtype equals its flax module's
  (``capture_intermediates``), on the plain and the kernel configuration.
- The cloud+image network at ``tests/test_bf16.py``'s size (plane 32, ALTO
  and image U-Net depth 3, start 8, output 64, 2 x 512 points) served in
  bf16 on the plain path, with the conv kernels (``fused_convs``,
  ``fused_head``) and under FAST_CONV: the port's heights no further from
  JAX's f32 heights than 2x JAX's own bf16 heights are (max and mean |d|),
  correlation > 0.999, and the JAX gate (0.15 x scale, correlation > 0.99).
- One L1 ``Trainer`` step in bf16 against JAX's f32 step: the loss within
  2x JAX's own bf16 step's distance from it, and each gradient tensor
  within 2x that distance (norm-relative), or 2^-8 (one bf16 rounding)
  where JAX's is below it.

The weights are flax's init with biases drawn at std 0.1.
- bf16 accepted on every sorted layout (``tests/test_torch_bf16_sorted.py``
  holds fused2 to the JAX package, ``tests/test_torch_bf16_tiles.py``
  ``fused``, ``pallas`` and ``cumsum``); unknown dtypes refused.

The JAX references are computed once per module (fixtures): its bf16
gradient at a larger size does not finish in 100 s on this CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.models import blocks as jax_blocks  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops.pallas.conv_kernel import pallas_conv3x3  # noqa: E402
from tomosar2height_tpu.ops.pallas.convpair_kernel import fused_conv_pair  # noqa: E402
from tomosar2height_tpu.ops.pallas.decoder_kernel import fused_conv_decoder  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.models.blocks import set_fast_conv  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda.conv_kernel import conv3x3  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda.convpair_kernel import conv_pair  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda.decoder_kernel import conv_decoder  # noqa: E402
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    load_flax_params,
    state_dict_to_flax,
)

BF = torch.bfloat16
ULP = 2.0 ** -8  # a bf16 rounding, relative


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the test run shares the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x) -> torch.Tensor:
    """A numpy or JAX array as a torch tensor, bf16 kept."""
    a = jnp.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF)
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """A torch tensor or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def conv_weights(rng, cin, cout, k=3):
    std = min(0.2, (k * k * cin) ** -0.5)
    return (rng.normal(0, std, (k, k, cin, cout)).astype(np.float32),
            rng.normal(0, 0.1, cout).astype(np.float32))


def bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _held(got, want_bf16, want_f32):
    """got (the port, bf16 rule) within max(4 x floor, 1e-2) of the f32
    oracle, floor the JAX bf16 kernel's distance from it; and within one bf16
    rounding (plus one at the output's scale) of the JAX bf16 kernel."""
    got, ref, oracle = n(got), n(want_bf16), n(want_f32)
    floor = np.abs(ref - oracle).max()
    err = np.abs(got - oracle).max()
    assert err <= max(4 * floor, 1e-2), (err, floor)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=ULP, atol=ULP * scale)


def _grads_held(got, want):
    """The port's gradients against JAX's: same dtypes, within one bf16
    rounding of each tensor's scale (bf16 grads are the f32 composition's
    cast once; f32 grads differ by summation order)."""
    for g, w in zip(got, want):
        assert g.dtype == {"bfloat16": BF, "float32": torch.float32}[str(w.dtype)]
        scale = np.abs(n(w)).max()
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=ULP * scale)


@pytest.mark.parametrize("cin", [3, 8])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_bf16_matches_jax(cin, relu):
    """K8's bf16 rule: bf16 x and kernel (cast by the caller), the f32 bias."""
    rng = np.random.default_rng(cin)
    x = rng.normal(0, 1, (2, 16, 24, cin)).astype(np.float32)
    k, b = conv_weights(rng, cin, 16)
    want = pallas_conv3x3(bf16(x), bf16(k), jnp.asarray(b), relu=relu)
    oracle = pallas_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), relu=relu)
    xt, kt, bt = (t(bf16(x)).requires_grad_(), t(bf16(k)).requires_grad_(),
                  t(b).requires_grad_())
    got = conv3x3(xt, kt, bt, relu)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _held(got, want, oracle)
    g = rng.normal(0, 1, got.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: pallas_conv3x3(*a, relu=relu), bf16(x), bf16(k), jnp.asarray(b))
    got.backward(t(bf16(g)))
    _grads_held((xt.grad, kt.grad, bt.grad), vjp(bf16(g)))


@pytest.mark.parametrize("cin", [3, 8])
@pytest.mark.parametrize("pool", [False, True])
def test_conv_pair_bf16_matches_jax(cin, pool):
    """K7's bf16 rule: the f32 parameters rounded inside, relu(conv1) in
    bf16, bf16 y and pool."""
    rng = np.random.default_rng(10 + cin)
    x = rng.normal(0, 1, (2, 16, 24, cin)).astype(np.float32)
    ws = (*conv_weights(rng, cin, 8), *conv_weights(rng, 8, 12))
    want = fused_conv_pair(bf16(x), *map(jnp.asarray, ws), pool)
    oracle = fused_conv_pair(jnp.asarray(x), *map(jnp.asarray, ws), pool)
    leaves = [t(bf16(x)).requires_grad_()] + [t(w).requires_grad_() for w in ws]
    got = conv_pair(*leaves, pool)
    outs = [0] + ([1] if pool else [])
    for i in outs:
        assert got[i].dtype == BF and want[i].dtype == jnp.bfloat16
        _held(got[i], want[i], oracle[i])
    gs = [rng.normal(0, 1, got[i].shape).astype(np.float32) for i in outs]
    if pool:
        _, vjp = jax.vjp(lambda *a: fused_conv_pair(*a, True), bf16(x), *map(jnp.asarray, ws))
        jgrads = vjp(tuple(bf16(g) for g in gs))
    else:
        _, vjp = jax.vjp(lambda *a: fused_conv_pair(*a, False)[0], bf16(x),
                         *map(jnp.asarray, ws))
        jgrads = vjp(bf16(gs[0]))
    torch.autograd.backward([got[i] for i in outs], [t(bf16(g)) for g in gs])
    _grads_held([a.grad for a in leaves], jgrads)


@pytest.mark.parametrize("cin", [3, 8])
def test_conv_decoder_bf16_matches_jax(cin):
    """K6's bf16 rule: every parameter rounded inside, x1..x3 in bf16, the
    head in f32 onto the rounded b4; float32 out."""
    rng = np.random.default_rng(20 + cin)
    x = rng.normal(0, 1, (2, 16, 16, cin)).astype(np.float32)
    ws = (*conv_weights(rng, cin, 8), *conv_weights(rng, 8, 16), *conv_weights(rng, 16, 8),
          *conv_weights(rng, cin + 32, 1, k=1))
    want = fused_conv_decoder(bf16(x), *map(jnp.asarray, ws))
    oracle = fused_conv_decoder(jnp.asarray(x), *map(jnp.asarray, ws))
    leaves = [t(bf16(x)).requires_grad_()] + [t(w).requires_grad_() for w in ws]
    got = conv_decoder(*leaves)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _held(got, want, oracle)
    g = rng.normal(0, 1, got.shape).astype(np.float32)
    _, vjp = jax.vjp(fused_conv_decoder, bf16(x), *map(jnp.asarray, ws))
    got.backward(t(g))
    _grads_held([a.grad for a in leaves], vjp(jnp.asarray(g)))


# -- the network ---------------------------------------------------------------

RESO, N, B, OUT = 32, 512, 2, 64
Z_SCALE = 60.0


def net_cfg(dtype: str, fused: bool = False, sort: bool = False) -> dict:
    """The cloud+image network at tests/test_bf16.py's size."""
    return {
        "use_cloud": True, "use_image": True, "use_footprint": False,
        "dataset": {"normalize": {"z_bound": [0.0, Z_SCALE]}, "points": {"sort": sort}},
        "model": {
            "encoder": "pointnet_local_pool", "dtype": dtype,
            "encoder_kwargs": {
                "hidden_dim": 8, "feature_dim": 8, "plane_resolution": RESO,
                "scatter_type": "max", "sorted_impl": "fused2", "unet_type": "alto",
                "unet_kwargs": {"depth": 3, "merge_mode": "concat", "start_filts": 8,
                                "fused_convs": fused}},
            "encoder2": "unet",
            "encoder2_kwargs": {"num_classes": 8, "in_channels": 3, "depth": 3,
                                "merge_mode": "concat", "start_filts": 8,
                                "fused_convs": fused},
            "decoder_pixel_kwargs": {
                "mode": "conv", "use_footprint": False, "hidden_dim": 8, "out_dim": 1,
                "output_size": OUT, "sample_mode": "bilinear", "leaky": False,
                "fused_head": fused}}}


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "points": rng.uniform(0.01, 0.99, (B, N, 3)).astype(np.float32),
        "point_mask": rng.random((B, N)) > 0.05,
        "image": rng.normal(0, 1, (B, OUT, OUT, 3)).astype(np.float32),
        "dsm": np.where(rng.random((B, OUT, OUT)) < 0.5, 0.0,
                        rng.uniform(0.5, 30.0, (B, OUT, OUT))).astype(np.float32),
        "patch_valid": np.array([True] * B)}


@pytest.fixture(scope="module")
def params():
    """flax's init, with biases drawn at std 0.1 (init makes them 0, and the
    bf16 rules differ in where a bias is rounded)."""
    x = inputs()
    params = jax.jit(jax_build_model(net_cfg("float32")).init)(
        jax.random.PRNGKey(0), jnp.asarray(x["points"]), jnp.asarray(x["point_mask"]),
        jnp.asarray(x["image"]))
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(rng.normal(0, 0.1, v.shape).astype(np.float32))
                         if path[-1].key == "bias" else v), params)


def port_model(params, dtype: str, fused: bool = False):
    return load_flax_params(build_model(net_cfg(dtype, fused), device="cpu"),
                            jax.tree.map(np.asarray, params)).eval()


def jax_heights(params, dtype: str, fused: bool = False) -> np.ndarray:
    x = inputs()
    model = jax_build_model(net_cfg(dtype, fused))
    pa, _ = jax.jit(model.apply)(params, jnp.asarray(x["points"]),
                                 jnp.asarray(x["point_mask"]), jnp.asarray(x["image"]))
    return np.asarray(pa[..., 0])


VARIANTS = {"plain": (False, False), "kernels": (True, False), "fast_conv": (False, True)}


@pytest.fixture(scope="module")
def served(params):
    """JAX's f32 heights; then per variant JAX's and the port's bf16 heights."""
    out = {"f32": jax_heights(params, "float32")}
    x = inputs()
    for name, (fused, fast) in VARIANTS.items():
        jax_blocks.set_fast_conv(fast)
        set_fast_conv(fast)
        try:
            jb = jax_heights(params, "bfloat16", fused)
            with torch.no_grad():
                pa, pb = port_model(params, "bfloat16", fused)(
                    t(x["points"]), t(x["point_mask"]), t(x["image"]))
        finally:
            jax_blocks.set_fast_conv(False)
            set_fast_conv(False)
        assert pa.dtype == torch.float32 and pb is None
        out[name] = (jb, pa[..., 0].numpy())
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_served_heights_within_jax_floor(served, variant):
    ref = served["f32"]
    jb, mine = served[variant]
    scale = max(np.abs(ref).max(), 1.0)
    floor = np.abs(jb - ref)
    d = np.abs(mine - ref)
    assert floor.max() > 0  # bf16 moved JAX's heights: the floor is real
    assert d.max() <= 2 * floor.max(), (d.max(), floor.max())
    assert d.mean() <= 2 * floor.mean(), (d.mean(), floor.mean())
    assert np.corrcoef(ref.ravel(), mine.ravel())[0, 1] > 0.999
    # JAX's own gate (tests/test_bf16.py:14-39)
    assert d.max() / scale < 0.15
    assert np.corrcoef(ref.ravel(), mine.ravel())[0, 1] > 0.99


def _flax_dtypes(tree, prefix=()):
    """{module path: [output dtypes]} of flax's captured intermediates."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[prefix] = [str(a.dtype) for a in jax.tree.leaves(v)]
        else:
            out.update(_flax_dtypes(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_dtype_map_matches_flax(params, fused):
    x = inputs()
    model = jax_build_model(net_cfg("bfloat16", fused))
    _, state = jax.jit(lambda p, *a: model.apply(p, *a, capture_intermediates=True,
                                                 mutable=["intermediates"]))(
        params, jnp.asarray(x["points"]), jnp.asarray(x["point_mask"]),
        jnp.asarray(x["image"]))
    want = _flax_dtypes(state["intermediates"])
    port = port_model(params, "bfloat16", fused)
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
        port(t(x["points"]), t(x["point_mask"]), t(x["image"]))
    for h in handles:
        h.remove()
    both = sorted(set(got) & set(want))
    assert len(both) >= (30 if fused else 60), len(both)
    mismatched = {k: (got[k], want[k]) for k in both if got[k] != want[k]}
    assert not mismatched, mismatched
    assert "bfloat16" in {d for k in both for d in got[k]}


@pytest.fixture(scope="module")
def steps(params):
    """JAX's f32 and bf16 L1 steps (loss_l1, gradients) and the port's bf16
    one, from the same weights on the same batch."""
    batch = inputs(1)
    out = {}
    for dt in ("float32", "bfloat16"):
        jt = JaxTrainer(jax_build_model(net_cfg(dt)), {"optimize_every": 2,
                                                        "wire_dsm_dtype": "float32"},
                        use_cloud=True, use_image=True, use_footprint=False,
                        mesh=make_mesh(1), donate=False)
        (_, m), g = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
            params, jt.prepare_batch(batch))
        out[dt] = float(m["loss_l1"]), jax.tree.map(np.asarray, g)
    trainer = Trainer(port_model(params, "bfloat16"),
                      {"optimize_every": 2, "wire_dsm_dtype": "float32"}, use_image=True)
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
    """Each tensor's |g_port - g_f32| / |g_f32| within 2x JAX's bf16 step's
    (or 2^-8), and so over all tensors."""
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


# -- the sorted layouts, and refusals -----------------------------------------------

@pytest.mark.parametrize("impl", ["fused", "pallas", "cumsum"])
def test_build_refuses_bf16_on_sorted_layouts(impl):
    """No sorted layout is refused in bf16 any longer: ``build_model`` builds
    each (its kernels K9-K14 have bf16 instances)."""
    cfg = net_cfg("bfloat16", sort=True)
    cfg["model"]["encoder_kwargs"]["sorted_impl"] = impl
    model = build_model(cfg, device="cpu")
    assert model.point_encoder.sorted_impl == impl
    assert model.point_encoder.dtype == BF


def test_build_accepts_bf16_on_fused2():
    model = build_model(net_cfg("bfloat16", sort=True), device="cpu")
    assert model.point_encoder.sorted_impl == "fused2"
    assert model.point_encoder.dtype == BF


@pytest.mark.parametrize("impl", ["fused", "pallas", "cumsum"])
def test_encoder_refuses_bf16_sorted_batches(impl):
    """The point encoder no longer refuses a sorted batch in bf16: each
    layout's batch (cells recomputed from the points) serves to finite f32
    heights."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import (
        host_morton_bucket,
        host_morton_bucket_aligned,
    )

    cfg = net_cfg("bfloat16")
    cfg["model"]["encoder_kwargs"]["sorted_impl"] = impl
    model = build_model(cfg, device="cpu")
    x = inputs()
    if impl == "fused":
        rows = [host_morton_bucket_aligned(x["points"][i], x["point_mask"][i], RESO,
                                           tile_cells=256) for i in range(B)]
        pts, mask, offsets = (torch.from_numpy(np.stack([r[k] for r in rows]))
                              for k in ("points", "mask", "tile_offsets"))
    else:
        rows = [host_morton_bucket(x["points"][i], x["point_mask"][i], RESO) for i in range(B)]
        pts = torch.from_numpy(np.stack([x["points"][i][o] for i, (o, _, _) in enumerate(rows)]))
        mask = torch.from_numpy(np.stack([x["point_mask"][i][o]
                                          for i, (o, _, _) in enumerate(rows)]))
        offsets = torch.from_numpy(np.stack([off for _, _, off in rows]))
    with torch.no_grad():
        pa, _ = model(pts, mask, t(x["image"]), None, offsets)
    assert pa.dtype == torch.float32 and pa.shape == (B, OUT, OUT, 1)
    assert torch.isfinite(pa).all()


def test_encoder_serves_bf16_fused2_batches():
    """The aligned layout's batch (cells recomputed from the points) runs in
    bf16 on fused2 to finite f32 heights."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import host_morton_bucket_aligned

    x = inputs()
    rows = [host_morton_bucket_aligned(x["points"][i], x["point_mask"][i], RESO)
            for i in range(B)]
    pts, mask, offsets = (torch.from_numpy(np.stack([r[k] for r in rows]))
                          for k in ("points", "mask", "tile_offsets"))
    model = build_model(net_cfg("bfloat16"), device="cpu")
    with torch.no_grad():
        pa, _ = model(pts, mask, t(x["image"]), None, offsets)
    assert pa.dtype == torch.float32 and pa.shape == (B, OUT, OUT, 1)
    assert torch.isfinite(pa).all()


@pytest.mark.parametrize("dtype", ["float16", "float64", "bf16"])
def test_build_refuses_other_dtypes(dtype):
    with pytest.raises(NotImplementedError, match="model.dtype"):
        build_model(net_cfg(dtype), device="cpu")
