"""The PyTorch port's network against the JAX package on the same inputs.

Weights are made by flax ``init`` and carried across by the port's weight
bridge; points are made with numpy from a seed. The JAX ``fused2`` path runs
its Pallas kernels in interpret mode (they pick it themselves off-TPU); the
port's ``fused2`` path runs the kernels' plain versions on the CPU.
Tolerances are the JAX package's: 2e-4 for the encoder plane
(tests/test_fused_level.py) and 2e-4 * z_scale for heights in meters.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops.sorted_scatter import (  # noqa: E402
    aligned_bucket_size as jax_aligned_bucket_size,
    host_morton_bucket_aligned as jax_host_morton_bucket_aligned,
)
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.models.blocks import init_weights  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    flatten_tree,
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)

RESO = 64
N = 1500
B = 2
Z_BOUND = [0.0, 60.0]
Z_SCALE = Z_BOUND[1] - Z_BOUND[0]


def small_cfg(sorted_impl: str) -> dict:
    """The flagship network cut to CPU size: plane 64, depth 3, widths 8."""
    return {
        "use_cloud": True, "use_image": False,
        "dataset": {"normalize": {"z_bound": list(Z_BOUND)}},
        "model": {
            "encoder": "pointnet_local_pool",
            "encoder_kwargs": {
                "hidden_dim": 8, "feature_dim": 8, "plane_resolution": RESO,
                "scatter_type": "max", "sorted_impl": sorted_impl,
                "unet_type": "alto",
                "unet_kwargs": {"depth": 3, "merge_mode": "concat",
                                "start_filts": 8}},
            "decoder_pixel_kwargs": {
                "mode": "conv", "use_footprint": False, "hidden_dim": 8,
                "out_dim": 1, "output_size": 128, "sample_mode": "bilinear",
                "leaky": False},
        },
    }


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    pts = rng.uniform(0.001, 0.999, (B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) > 0.05
    npad = jax_aligned_bucket_size(N, RESO)
    apts = np.full((B, npad, 3), 0.5, np.float32)
    amask = np.zeros((B, npad), bool)
    acell = np.zeros((B, npad), np.int32)
    atoff = np.zeros((B, RESO * RESO // 1024 + 1), np.int32)
    for i in range(B):
        a = jax_host_morton_bucket_aligned(pts[i], mask[i], RESO)
        apts[i], amask[i], acell[i], atoff[i] = (
            a["points"], a["mask"], a["cells"], a["tile_offsets"])
    return dict(pts=pts, mask=mask, apts=apts, amask=amask, acell=acell,
                atoff=atoff)


@pytest.fixture(scope="module")
def params(data):
    model = jax_build_model(small_cfg("cumsum"))
    p = model.init(jax.random.PRNGKey(0), jnp.asarray(data["pts"]),
                   jnp.asarray(data["mask"]))
    return jax.tree.map(np.asarray, p)


def _port(sorted_impl, params):
    model = build_model(small_cfg(sorted_impl), device="cpu")
    load_flax_params(model, params)
    return model.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


class TestBridge:
    def test_round_trip(self, params):
        back = state_dict_to_flax(flax_to_state_dict(params))
        a, b = flatten_tree(params["params"]), flatten_tree(back["params"])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=str(k))

    def test_keys_cover_the_port(self, params):
        model = build_model(small_cfg("fused2"), device="cpu")
        assert set(flax_to_state_dict(params)) == set(model.state_dict())

    def test_seeded_init_is_xavier(self):
        model = build_model(small_cfg("fused2"), device="cpu")
        init_weights(model, torch.Generator().manual_seed(0))
        w = model.point_encoder.fc_pos.weight.detach()
        bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
        assert float(w.abs().max()) <= bound
        assert float(model.point_encoder.fc_pos.bias.detach().abs().max()) == 0.0
        again = init_weights(build_model(small_cfg("fused2"), device="cpu"),
                             torch.Generator().manual_seed(0))
        for k, v in model.state_dict().items():
            assert torch.equal(v, again.state_dict()[k]), k


class TestForward:
    def test_encoder_plane_fused2(self, data, params):
        from tomosar2height_tpu.models.pointnet import LocalPoolPointnet

        cfg = small_cfg("fused2")["model"]["encoder_kwargs"]
        enc = LocalPoolPointnet(dtype=jnp.float32, **cfg)
        want = enc.apply({"params": params["params"]["point_encoder"]},
                         jnp.asarray(data["apts"]), jnp.asarray(data["amask"]),
                         jnp.asarray(data["acell"]), jnp.asarray(data["atoff"]))["xy"]
        with torch.inference_mode():
            got = _port("fused2", params).point_encoder(
                _t(data["apts"]), _t(data["amask"]), _t(data["acell"]),
                _t(data["atoff"]))["xy"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_heights_fused2(self, data, params):
        jm = jax_build_model(small_cfg("fused2"))
        want, _ = jm.apply(params, jnp.asarray(data["apts"]), jnp.asarray(data["amask"]),
                           None, jnp.asarray(data["acell"]), jnp.asarray(data["atoff"]))
        with torch.inference_mode():
            got, fp = _port("fused2", params)(
                _t(data["apts"]), _t(data["amask"]), None, _t(data["acell"]),
                _t(data["atoff"]))
        assert fp is None and got.shape == (B, 128, 128, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4 * Z_SCALE)

    def test_heights_fused2_device_cells(self, data, params):
        """cells=None with offsets: the port recomputes cell ids from points."""
        model = _port("fused2", params)
        with torch.inference_mode():
            a, _ = model(_t(data["apts"]), _t(data["amask"]), None,
                         _t(data["acell"]), _t(data["atoff"]))
            b, _ = model(_t(data["apts"]), _t(data["amask"]), None, None,
                         _t(data["atoff"]))
        assert torch.equal(a, b)

    def test_heights_plain_vs_cumsum(self, data, params):
        jm = jax_build_model(small_cfg("cumsum"))
        want, _ = jm.apply(params, jnp.asarray(data["pts"]), jnp.asarray(data["mask"]))
        with torch.inference_mode():
            got, _ = _port("cumsum", params)(_t(data["pts"]), _t(data["mask"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4 * Z_SCALE)

    def test_unported_paths_raise(self):
        for impl in ("cumsum", "pallas", "fused"):
            model = build_model(small_cfg(impl), device="cpu")
            pts = torch.rand(1, 8, 3)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                model(pts, torch.ones(1, 8, dtype=torch.bool), None,
                      torch.zeros(1, 5, dtype=torch.int32), torch.zeros(1, 5, dtype=torch.int32))
