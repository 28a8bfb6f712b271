"""The port's network on the Morton-sorted serving paths against the JAX
package, on the same points and weights (flax ``init`` carried across by the
weight bridge).

- ``fused`` (aligned layout, 256-cell tiles): the port against the JAX
  ``fused`` model, whose Pallas kernels run in interpret mode on the CPU.
- ``pallas`` and ``cumsum`` (plain sorted layout): the port against the JAX
  ``cumsum`` model on the same batch. The JAX ``pallas`` model launches K11
  without interpret mode, so it cannot run on the CPU; the JAX package holds
  it to ``cumsum`` (tests/test_pallas_kernel.py).

Both scatter types (max and mean pooling). Tolerance 2e-4 * z_scale on the
heights, as tests/test_fused_model.py:73 holds the plane. Size: plane 64,
1500 points, depth 3, widths 8.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import RESO, Z_SCALE, small_cfg  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops.sorted_scatter import (  # noqa: E402
    aligned_bucket_size as jax_aligned_bucket_size,
    host_morton_bucket as jax_host_morton_bucket,
    host_morton_bucket_aligned as jax_host_morton_bucket_aligned,
)
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    flax_to_state_dict,
    load_flax_params,
)

N = 1500
B = 2


def _cfg(impl, scatter_type="max"):
    cfg = small_cfg(impl)
    cfg["model"]["encoder_kwargs"]["scatter_type"] = scatter_type
    return cfg


@pytest.fixture(scope="module")
def data():
    """One point set in three layouts: unsorted, aligned with 256-cell tiles
    ('fused') and plain sorted ('pallas'/'cumsum'), built by the JAX host code."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0.001, 0.999, (B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) > 0.05
    npad = jax_aligned_bucket_size(N, RESO, tile_cells=256)
    aligned = {"pts": np.zeros((B, npad, 3), np.float32), "mask": np.zeros((B, npad), bool),
               "cell": np.zeros((B, npad), np.int32),
               "off": np.zeros((B, RESO * RESO // 256 + 1), np.int32)}
    plain = {"pts": np.zeros_like(pts), "mask": np.zeros_like(mask),
             "cell": np.zeros((B, N), np.int32),
             "off": np.zeros((B, RESO * RESO + 1), np.int32)}
    for i in range(B):
        a = jax_host_morton_bucket_aligned(pts[i], mask[i], RESO, tile_cells=256)
        for k, key in (("pts", "points"), ("mask", "mask"), ("cell", "cells"),
                       ("off", "tile_offsets")):
            aligned[k][i] = a[key]
        order, plain["cell"][i], plain["off"][i] = jax_host_morton_bucket(pts[i], mask[i],
                                                                          RESO)
        plain["pts"][i], plain["mask"][i] = pts[i][order], mask[i][order]
    return {"unsorted": {"pts": pts, "mask": mask}, "fused": aligned, "sorted": plain}


@pytest.fixture(scope="module")
def params(data):
    model = jax_build_model(small_cfg("cumsum"))
    d = data["unsorted"]
    p = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(d["pts"]),
                            jnp.asarray(d["mask"]))
    return jax.tree.map(np.asarray, p)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_heights(cfg, params, d):
    return np.asarray(jax_build_model(cfg).apply(
        params, jnp.asarray(d["pts"]), jnp.asarray(d["mask"]), None,
        jnp.asarray(d["cell"]), jnp.asarray(d["off"]))[0])


def _port(cfg, params):
    return load_flax_params(build_model(cfg, device="cpu"), params).eval()


@pytest.mark.parametrize("scatter_type", ["max", "mean"])
def test_fused_matches_jax_fused(data, params, scatter_type):
    cfg = _cfg("fused", scatter_type)
    d = data["fused"]
    want = _jax_heights(cfg, params, d)
    with torch.inference_mode():
        got, _ = _port(cfg, params)(_t(d["pts"]), _t(d["mask"]), None, _t(d["cell"]),
                                    _t(d["off"]))
    assert got.shape == (B, 128, 128, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * Z_SCALE)


@pytest.mark.parametrize("impl,scatter_type", [("pallas", "max"), ("pallas", "mean"),
                                               ("cumsum", "max"), ("cumsum", "mean")])
def test_sorted_matches_jax_cumsum(data, params, impl, scatter_type):
    d = data["sorted"]
    want = _jax_heights(_cfg("cumsum", scatter_type), params, d)
    with torch.inference_mode():
        got, _ = _port(_cfg(impl, scatter_type), params)(
            _t(d["pts"]), _t(d["mask"]), None, _t(d["cell"]), _t(d["off"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * Z_SCALE)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_device_cells_match_the_layout(data, params, impl):
    """cells=None: the port recomputes the ids with the layout's pad rule
    (the sentinel on 'fused', reso**2 on 'pallas', pointnet.py:83-86)."""
    d = data["fused" if impl == "fused" else "sorted"]
    model = _port(_cfg(impl), params)
    with torch.inference_mode():
        a, _ = model(_t(d["pts"]), _t(d["mask"]), None, _t(d["cell"]), _t(d["off"]))
        b, _ = model(_t(d["pts"]), _t(d["mask"]), None, None, _t(d["off"]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["fused", "pallas", "cumsum"])
def test_bridge_names_cover_every_sorted_path(params, impl):
    """Every path reads the same fc_comm/fc_c (and every other) parameter:
    the flax tree maps onto each path's state_dict with no name left over."""
    model = build_model(_cfg(impl), device="cpu")
    assert set(flax_to_state_dict(params)) == set(model.state_dict())


def test_unknown_sorted_impl_raises():
    with pytest.raises(ValueError, match="sorted_impl"):
        build_model(_cfg("scan"), device="cpu")
