"""The port's dataset on disk against the JAX package's.

- ``build_dataset`` of a small synthetic city (the port's ``write_city``,
  whose files are ``scripts/make_synthetic_city.py``'s byte for byte) against
  the JAX builder, file by file: ``chunk_info.yaml`` and each chunk's PLY
  byte-equal, each ``input_point_cloud.npz`` array bit-equal. The JAX side
  reads the LAS with its numpy reader here: its C++ reader, where built,
  fuses ``x * scale + offset`` into one FMA (the default JAX build is held
  within an ulp of each column's largest coordinate).
- ``TomoSARDataset`` patches of the train (random anchors drawn from a
  per-item generator, as ``det_stream`` does), val, vis and test splits
  against JAX's, with ``local_min`` and ``global_min``, the GT and image
  crops bit-equal. The normalized points are bit-equal below 4096 points a
  patch, where the JAX dataset takes its numpy path; above that it may take
  its C++ path (when built), so there they are held within 1e-6.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tomosar2height_tpu import native
from tomosar2height_tpu.config import compose as jax_compose
from tomosar2height_tpu.config.compose import default_conf_dir as jax_conf_dir
from tomosar2height_tpu.data import TomoSARDataset as JaxDataset
from tomosar2height_tpu.data import build_dataset as jax_build_dataset
from tomosar2height_tpu_torch.config import compose, default_conf_dir
from tomosar2height_tpu_torch.data import TomoSARDataset, build_dataset
from tomosar2height_tpu_torch.data.synthetic import Y0, write_city

W, H = 512, 384
FAST_PATH_POINTS = 4096  # the JAX dataset's C++ path starts here (dataset.py:234)


def overrides(root, out="generated"):
    return [
        "dataset=synthetic", f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud", f"output.output_folder={root}/{out}",
        f"dataset.path={root}/{out}", f"dataset.satellite_image.folder={root}/raster",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        f"chunk.chunk_x=[0.0,256.0,{float(W)}]",
        f"chunk.chunk_y=[{Y0},{Y0 + 192.0},{Y0 + H}]",
        "dataset.train_chunks=[0,1]", "dataset.val_chunks=[2]", "dataset.test_chunks=[3]",
        "dataset.vis_chunks=[3]", "dataset.patch_size=[128,128]",
        "dataset.sliding_window.val_strip=[128,128]",
        "dataset.sliding_window.vis_strip=[64,64]",
        "dataset.sliding_window.test_strip=[64,64]"]


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dataset_city"))
    write_city(root, seed=4, density=0.25, W=W, H=H)
    return root


@pytest.fixture()
def jax_numpy_las(monkeypatch):
    monkeypatch.setattr(native, "las_read", lambda path: None)


@pytest.fixture(scope="module")
def built(city):
    info = build_dataset(compose(default_conf_dir(), overrides=overrides(city)))
    return city, info


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_builder_files_equal_jax(built, jax_numpy_las):
    root, info = built
    ref = jax_build_dataset(jax_compose(jax_conf_dir(), overrides=overrides(root, "jax")))
    assert info == ref and len(info) == 4
    mine, theirs = os.path.join(root, "generated"), os.path.join(root, "jax")
    assert _files(mine) == _files(theirs)
    assert "chunk_info.yaml" in _files(mine)
    for name in _files(mine):
        a, b = os.path.join(mine, name), os.path.join(theirs, name)
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert list(za) == list(zb) == ["pts"]
                assert za["pts"].dtype == zb["pts"].dtype == np.float64
                np.testing.assert_array_equal(za["pts"], zb["pts"])
                assert len(za["pts"]) > 0
        else:  # chunk_info.yaml and the chunks' PLY files
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def fma_close(a, b):
    """Within an ulp of each column's largest magnitude: one rounding of
    ``x * scale`` more or less, seen in the sum with the offset."""
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= np.spacing(np.abs(b).max(axis=0)))


def test_builder_within_an_ulp_of_the_default_jax_build(built):
    root, _ = built
    jax_build_dataset(jax_compose(jax_conf_dir(), overrides=overrides(root, "jax_default")))
    for k in range(4):
        name = f"chunk_{k:03d}/input_point_cloud.npz"
        with np.load(os.path.join(root, "generated", name)) as za, \
                np.load(os.path.join(root, "jax_default", name)) as zb:
            fma_close(za["pts"], zb["pts"])


def test_builder_refuses_an_existing_folder(built):
    root, _ = built
    with pytest.raises(FileExistsError, match="overwrite"):
        build_dataset(compose(default_conf_dir(), overrides=overrides(root)))


def _compare(mine, ref, counts):
    assert mine.keys() <= ref.keys()
    assert mine["name"] == ref["name"] and mine["is_valid"] == ref["is_valid"]
    np.testing.assert_array_equal(mine["min_bound"], ref["min_bound"])
    np.testing.assert_array_equal(mine["max_bound"], ref["max_bound"])
    if not mine["is_valid"]:
        return
    a, b = mine["inputs"], ref["inputs"]
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    n = len(a)
    counts.append(n)
    if n < FAST_PATH_POINTS:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for key in ("dsm", "image"):
        assert (key in mine) == (key in ref), key
        if key in mine:
            assert mine[key].dtype == ref[key].dtype == np.float32
            np.testing.assert_array_equal(mine[key], ref[key])


@pytest.mark.parametrize("z_shift", ["local_min", "global_min"])
@pytest.mark.parametrize("split", ["train", "val", "vis", "test"])
def test_patches_equal_jax(built, split, z_shift):
    root, _ = built
    ov = overrides(root) + [f"dataset.normalize.z_shift={z_shift}", "use_image=true"]
    cfg, jcfg = compose(default_conf_dir(), overrides=ov), jax_compose(jax_conf_dir(),
                                                                        overrides=ov)
    kwargs = dict(random_sample=split == "train", random_length=12 if split == "train" else None,
                  load_target=split != "vis", load_image=True)
    mine = TomoSARDataset(split, cfg["dataset"], **kwargs)
    ref = JaxDataset(split, jcfg["dataset"], **kwargs)
    assert len(mine) == len(ref) > 0
    assert mine.chunk_info == ref.chunk_info
    counts = []
    for i in range(len(mine)):
        if split == "train":  # the det_stream loader's per-item generators
            seq = np.random.SeedSequence([7, 1, i])
            a = mine.__getitem__(i, np.random.default_rng(seq))
            b = ref.__getitem__(i, np.random.default_rng(seq))
        else:
            a, b = mine[i], ref[i]
        _compare(a, b, counts)
    assert counts, "no valid patch"
    if split in ("vis", "test"):  # both regimes of the JAX dataset are covered
        assert min(counts) < FAST_PATH_POINTS <= max(counts), counts


def test_patches_without_image_or_target(built):
    root, _ = built
    cfg = compose(default_conf_dir(), overrides=overrides(root))
    mine = TomoSARDataset("val", cfg["dataset"], load_target=False, load_image=False)
    ref = JaxDataset("val", cfg["dataset"], load_target=False, load_image=False)
    assert mine.image is None and ref.n_images == 0
    counts = []
    for i in range(len(mine)):
        assert "image" not in mine[i] and "dsm" not in mine[i]
        _compare(mine[i], ref[i], counts)


@pytest.mark.parametrize("override,match", [
    ("dataset.satellite_image.pairs=[rgb.tif,rgb.tif]", "ROADMAP: alternates"),
])
def test_unported_options_raise(built, override, match):
    root, _ = built
    cfg = compose(default_conf_dir(), overrides=overrides(root) + [override])
    with pytest.raises(NotImplementedError, match=match):
        TomoSARDataset("val", cfg["dataset"])


def test_augmentation_and_unknown_shift_raise(built):
    """Augmentation runs now (tests/test_torch_augment.py holds it to the JAX
    dataset); an unknown z shift still raises."""
    root, _ = built
    cfg = compose(default_conf_dir(), overrides=overrides(root))
    ds = TomoSARDataset("train", cfg["dataset"], random_sample=True, random_length=2,
                        flip_augm=True)
    assert ds.flip_augm and "flip" in ds.__getitem__(0, np.random.default_rng(0))
    cfg = compose(default_conf_dir(), overrides=overrides(root)
                  + ["dataset.normalize.z_shift=median"])
    with pytest.raises(ValueError, match="shift strategy"):
        TomoSARDataset("val", cfg["dataset"])
