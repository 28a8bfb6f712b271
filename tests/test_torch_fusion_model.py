"""The port's cloud+image fusion network against the JAX package.

The fusion network (ALTO point branch + image U-Net, planes summed in the
pixel decoder, optional footprint head) cut to CPU size: ALTO depth 3 and
image U-Net depth 3, both start 8, on a 32^2 plane and a 32^2 image, output
32. One set of flax weights goes through the port's weight bridge (which
raises on any key that does not match, so the image U-Net and the footprint
head are covered). Both packages run with the kernel flags set
(``fused_convs``, ``fused_head``; JAX's Pallas kernels in interpret mode, the
port's plain versions) and unset. Tolerance: 2e-4 (tests/test_fused_model.py:73)
on footprint logits, 2e-4 * z_scale on heights in meters.
"""

from __future__ import annotations

import copy

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
from tomosar2height_tpu_torch.models.blocks import set_fast_conv  # noqa: E402
from tomosar2height_tpu_torch.ops.resize import resize_bilinear  # noqa: E402
from tomosar2height_tpu_torch.train import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import load_flax_params  # noqa: E402

RESO = 32
N = 600
B = 2
Z_BOUND = [0.0, 60.0]
Z_SCALE = Z_BOUND[1] - Z_BOUND[0]


def fusion_cfg(fused: bool, footprint: bool) -> dict:
    return {
        "use_cloud": True, "use_image": True,
        "dataset": {"normalize": {"z_bound": list(Z_BOUND)}},
        "model": {
            "encoder": "pointnet_local_pool",
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
                "mode": "conv", "use_footprint": footprint, "hidden_dim": 8,
                "out_dim": 1, "output_size": 32, "sample_mode": "bilinear",
                "leaky": False, "fused_head": fused},
        },
    }


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
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
    img = rng.normal(0, 1, (B, 32, 32, 3)).astype(np.float32)
    return dict(apts=apts, amask=amask, acell=acell, atoff=atoff, img=img)


def _jax_args(data):
    return (jnp.asarray(data["apts"]), jnp.asarray(data["amask"]),
            jnp.asarray(data["img"]), jnp.asarray(data["acell"]),
            jnp.asarray(data["atoff"]))


@pytest.fixture(scope="module")
def params(data):
    p = jax.jit(jax_build_model(fusion_cfg(False, True)).init)(jax.random.PRNGKey(1),
                                                               *_jax_args(data))
    return jax.tree.map(np.asarray, p)


def _params_for(params, footprint):
    if footprint:
        return params
    p = copy.deepcopy(params)
    del p["params"]["decoder"]["conv_decoder_footprint"]
    return p


@pytest.mark.parametrize("footprint", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_fusion_matches_jax(data, params, fused, footprint):
    cfg = fusion_cfg(fused, footprint)
    p = _params_for(params, footprint)
    want_a, want_b = jax.jit(jax_build_model(cfg).apply)(p, *_jax_args(data))
    model = load_flax_params(build_model(cfg, device="cpu"), p).eval()
    with torch.inference_mode():
        got_a, got_b = model(*(torch.from_numpy(data[k]) for k in
                               ("apts", "amask", "img", "acell", "atoff")))
    assert got_a.shape == (B, 32, 32, 1)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0,
                               atol=2e-4 * Z_SCALE)
    if footprint:
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=2e-4)
    else:
        assert got_b is None and want_b is None


def test_footprint_skip_and_fast_conv(data, params):
    """``footprint=False`` returns the same heights without the footprint
    head; the FAST_CONV switch (K8 on the card, the plain conv here) gives
    the same outputs."""
    model = load_flax_params(build_model(fusion_cfg(False, True), device="cpu"),
                             params).eval()
    args = [torch.from_numpy(data[k]) for k in ("apts", "amask", "img", "acell", "atoff")]
    with torch.inference_mode():
        a, b = model(*args)
        a2, b2 = model(*args, footprint=False)
        set_fast_conv(True)
        try:
            a3, b3 = model(*args)
        finally:
            set_fast_conv(False)
    assert b2 is None and torch.equal(a, a2)
    torch.testing.assert_close(a3, a, rtol=0, atol=1e-6 * Z_SCALE)
    torch.testing.assert_close(b3, b, rtol=0, atol=1e-6)


def test_resize_to_the_same_size_is_the_identity():
    x = torch.randn(1, 8, 8, 3)
    assert resize_bilinear(x, 8) is x


def test_build_model_goes_to_the_card_or_raises():
    cfg = fusion_cfg(True, False)
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert next(build_model(cfg, device="cpu").parameters()).device.type == "cpu"


def test_unported_unet_modes_raise():
    cfg = fusion_cfg(False, False)
    cfg["model"]["encoder2_kwargs"]["up_mode"] = "upsample"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")


def test_missing_image_and_fusion_training_raise(data):
    """The fusion network without its image raises, and so does a Trainer
    for it: the image is not in ``prepare_batch`` yet."""
    model = build_model(fusion_cfg(False, False), device="cpu").eval()
    args = [torch.from_numpy(data[k]) for k in ("apts", "amask")]
    with pytest.raises(ValueError, match="input_image"):
        model(*args)
    with pytest.raises(NotImplementedError, match="ROADMAP: fusion training"):
        Trainer(model, {"optimize_every": 1})
