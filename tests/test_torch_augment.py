"""The port's flip/rotate augmentation and image wires against the JAX
package's dataset, on a small synthetic city built on disk.

- Augmented training patches (``flip_augm`` and ``rotate_augm``), for every
  (quarter turns, flip axis) pair, drawn through one generator stand-in that
  both datasets read in the same order (the anchor's two uniforms, the turns,
  the axis): points, the inverse normalization ``transform``, the image and
  nDSM crops and the draws bit-equal to the JAX dataset's; the transform maps
  the points back into the patch's world box. Then a det_stream run of real
  per-item generators, bit-equal.
- ``satellite_image.wire=uint8``: u8 crops (augmented too) bit-equal to JAX's,
  ``image_norm`` equal, and normalized they equal the f32 wire's crops
  within f32 rounding (1e-5, as JAX ``tests/test_data.py:242``); a source
  that is not integral u8 raises, as the JAX dataset's check does.
- ``satellite_image.crop=device``: a serving dataset ships the crop's origin
  (as JAX's), whose slice of ``scene_image_hwc`` flipped y-up is the host
  crop; training, augmented or target-carrying datasets keep host crops.

The JAX dataset's C++ patch path (>= 4096 points, where built) rounds the
transform otherwise (within 1e-6); it is held to its numpy path here.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from test_torch_dataset import W, H, overrides
from tomosar2height_tpu import native
from tomosar2height_tpu.config import compose as jax_compose
from tomosar2height_tpu.config.compose import default_conf_dir as jax_conf_dir
from tomosar2height_tpu.data import TomoSARDataset as JaxDataset
from tomosar2height_tpu.geo import FLIP_MATRICES as JAX_FLIP, ROT_MATRICES as JAX_ROT
from tomosar2height_tpu_torch.config import compose, default_conf_dir
from tomosar2height_tpu_torch.data import TomoSARDataset, build_dataset
from tomosar2height_tpu_torch.data.synthetic import write_city
from tomosar2height_tpu_torch.geo import FLIP_MATRICES, ROT_MATRICES, apply_transform


@pytest.fixture(autouse=True)
def jax_numpy_patches(monkeypatch):
    monkeypatch.setattr(native, "crop_transform_patch", lambda *a, **k: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("augment_city"))
    write_city(root, seed=5, density=0.2, W=W, H=H)
    build_dataset(compose(default_conf_dir(), overrides=overrides(root)))
    return root


def _cfgs(root, extra=()):
    ov = overrides(root) + ["use_image=true"] + list(extra)
    return (compose(default_conf_dir(), overrides=ov)["dataset"],
            jax_compose(jax_conf_dir(), overrides=ov)["dataset"])


@pytest.fixture(scope="module")
def augmented(root):
    """(port, JAX) training datasets with both augmentations, image and target."""
    mine, theirs = _cfgs(root)
    kw = dict(random_sample=True, random_length=8, flip_augm=True, rotate_augm=True)
    return TomoSARDataset("train", mine, **kw), JaxDataset("train", theirs, **kw)


class Draws:
    """A generator stand-in: ``random`` gives the anchor's uniforms,
    ``choice(4)`` the quarter turns, ``choice([-1, 0, 1])`` the flip axis."""

    def __init__(self, u, rot, flip):
        self.u, self.rot, self.flip = np.asarray(u, np.float64), rot, flip

    def random(self, n):
        return self.u[:n].copy()

    def choice(self, a):
        return self.rot if isinstance(a, int) else self.flip


def _assert_items_equal(a, b, image_dtype=np.float32):
    assert a.keys() == b.keys()
    for k in a:
        if k == "name" or k == "is_valid":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    if "image" in a:
        assert a["image"].dtype == b["image"].dtype == image_dtype


def test_matrices_equal_jax():
    for k in range(4):
        np.testing.assert_array_equal(ROT_MATRICES[k], JAX_ROT[k])
    for k in (-1, 0, 1):
        np.testing.assert_array_equal(FLIP_MATRICES[k], JAX_FLIP[k])


@pytest.mark.parametrize("flip", [-1, 0, 1])
@pytest.mark.parametrize("rot", [0, 1, 2, 3])
def test_augmented_items_equal_jax(augmented, rot, flip):
    mine, ref = augmented
    valid = 0
    for i, u in enumerate(([0.3, 0.6], [0.9, 0.1], [0.05, 0.95])):
        a = mine.__getitem__(i, Draws(u, rot, flip))
        b = ref.__getitem__(i, Draws(u, rot, flip))
        _assert_items_equal(a, b)
        if not a["is_valid"]:
            continue
        valid += 1
        assert (a["rotate"], a["flip"]) == (rot, flip)
        h, w = mine._dsm_patch_shape
        assert a["dsm"].shape == (h, w)
        assert a["image"].shape[:2] == tuple(mine._image_patch_shape)
        # the inverse normalization takes the patch's points back into its box
        world = apply_transform(a["inputs"], a["transform"])
        lo, hi = a["min_bound"], a["max_bound"]
        assert np.all(world[:, :2] >= lo - 1e-3) and np.all(world[:, :2] <= hi + 1e-3)
    assert valid >= 2


def test_augmented_stream_equal_jax(augmented):
    """Real per-item generators, as the det_stream loader keys them: the
    draws come out of the generator in the same order in both packages."""
    mine, ref = augmented
    draws = set()
    for i in range(len(mine)):
        seq = np.random.SeedSequence([3, 1, i])
        a = mine.__getitem__(i, np.random.default_rng(seq))
        b = ref.__getitem__(i, np.random.default_rng(seq))
        _assert_items_equal(a, b)
        if a["is_valid"]:
            draws.add((a["rotate"], a["flip"]))
    assert len(draws) >= 3


@pytest.mark.parametrize("split", ["train", "val"])
def test_u8_crops_equal_jax(root, split):
    mine, theirs = _cfgs(root, ["dataset.satellite_image.wire=uint8"])
    train = split == "train"
    kw = dict(random_sample=train, random_length=6 if train else None, flip_augm=train,
              rotate_augm=train)
    a_ds, b_ds = TomoSARDataset(split, mine, **kw), JaxDataset(split, theirs, **kw)
    for m, r in zip(a_ds.image_norm, b_ds.image_norm):
        assert m.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(m, r)
    for i in range(min(len(a_ds), 6)):
        if train:
            seq = np.random.SeedSequence([5, 1, i])
            a = a_ds.__getitem__(i, np.random.default_rng(seq))
            b = b_ds.__getitem__(i, np.random.default_rng(seq))
        else:
            a, b = a_ds[i], b_ds[i]
        _assert_items_equal(a, b, np.uint8)


def test_u8_normalized_equals_f32_wire(root):
    f32, _ = _cfgs(root)
    u8, _ = _cfgs(root, ["dataset.satellite_image.wire=uint8"])
    ds_f, ds_8 = TomoSARDataset("val", f32), TomoSARDataset("val", u8)
    assert ds_f.image_norm is None
    mean, std = ds_8.image_norm
    checked = 0
    for i in range(len(ds_f)):
        pf, p8 = ds_f[i], ds_8[i]
        if not pf["is_valid"]:
            continue
        norm = (p8["image"].astype(np.float32) - mean) / std
        np.testing.assert_allclose(norm, pf["image"], atol=1e-5, rtol=0)
        checked += 1
    assert checked


def test_u8_wire_refuses_a_non_integral_source(root):
    from tomosar2height_tpu_torch.data import SceneDataset
    from tomosar2height_tpu_torch.geo import RasterData

    cfg, _ = _cfgs(root, ["dataset.satellite_image.wire=uint8"])
    chunk = {"name": "c", "min_bound": [0.0, 0.0], "max_bound": [256.0, 256.0],
             "points": np.zeros((4, 3))}
    image = (np.full((3, 256, 256), 0.5, np.float32),
             RasterData((0.0, 0.0), (256.0, 256.0), (1.0, 1.0)))
    with pytest.raises(ValueError, match="integral u8"):
        SceneDataset([chunk], cfg, image=image)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_device_crop_origins_equal_jax(root, wire):
    mine, theirs = _cfgs(root, ["dataset.satellite_image.crop=device",
                                f"dataset.satellite_image.wire={wire}"])
    a_ds = TomoSARDataset("vis", mine, load_target=False)
    b_ds = JaxDataset("vis", theirs, load_target=False)
    assert a_ds.image_crop_device and b_ds.image_crop_device
    host_cfg = copy.deepcopy(mine)
    host_cfg["satellite_image"]["crop"] = "host"
    host = TomoSARDataset("vis", host_cfg, load_target=False)
    scene = a_ds.scene_image_hwc()
    np.testing.assert_array_equal(scene, b_ds.scene_image_hwc())
    h, w = a_ds._image_patch_shape
    for i in range(len(a_ds)):
        a, b = a_ds[i], b_ds[i]
        _assert_items_equal(a, b)
        if not a["is_valid"]:
            continue
        assert "image" not in a
        r0, c0 = a["image_origin"]
        np.testing.assert_array_equal(scene[r0:r0 + h, c0:c0 + w][::-1], host[i]["image"])


def test_device_crop_only_for_serving_datasets(root):
    mine, _ = _cfgs(root, ["dataset.satellite_image.crop=device"])
    train = TomoSARDataset("train", mine, random_sample=True, random_length=2,
                           flip_augm=True)
    val = TomoSARDataset("val", mine)  # carries targets
    for ds in (train, val):
        assert not ds.image_crop_device
        item = next(ds.__getitem__(i, np.random.default_rng(i)) for i in range(len(ds))
                    if ds.__getitem__(i, np.random.default_rng(i))["is_valid"])
        assert "image" in item and "image_origin" not in item
    with pytest.raises(ValueError, match="crop='device'"):
        val.scene_image_hwc()
