"""Sliding-window nDSM generation of the PyTorch port against the JAX package.

A tiny synthetic city is built as tests/test_e2e.py does. The port's
``DSMGenerator`` runs the ``fused2`` path (aligned loader; the kernels' plain
versions on the CPU), the JAX ``DSMGenerator`` its plain unsorted path, with
the same small model and weights. The rasters must share shape, transform and
NaN mask, and agree within 2e-4 * z_scale meters; so must the rasters of the
cloud+image network, the port with its kernel flags set, from the city's RGB
image. Also pinned here: the port's serving dataset (image crops included)
and loader against the JAX ones (bit-identical), and the port's flagship and
fusion config literals against ``compose()``.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from tomosar2height_tpu.config import compose  # noqa: E402
from tomosar2height_tpu.config.compose import default_conf_dir  # noqa: E402
from tomosar2height_tpu.data import PatchLoader as JaxPatchLoader  # noqa: E402
from tomosar2height_tpu.data import TomoSARDataset, build_dataset  # noqa: E402
from tomosar2height_tpu.geo import RasterReader  # noqa: E402
from tomosar2height_tpu_torch.config import flagship_config, fusion_config  # noqa: E402
from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterData  # noqa: E402
from tomosar2height_tpu_torch.infer.generator import make_generator  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import load_flax_params  # noqa: E402

BUCKET = 4096


def _overrides(root):
    return [
        "dataset=synthetic",
        f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud",
        f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        "dataset.patch_size=[128,128]",
        # a stride above the patch size leaves gaps: NaN in both rasters
        "dataset.sliding_window.test_strip=[256,256]",
        f"dataset.points.bucket_sizes=[{BUCKET}]",
        f"dataset.points.train_bucket={BUCKET}",
        "dsm_generation.pixel_size=[2,2]",
        "use_image=false",
        "use_footprint=false",
        "training.val_batch_size=2",
        "model.encoder_kwargs.plane_resolution=64",
        "model.encoder_kwargs.hidden_dim=8",
        "model.encoder_kwargs.feature_dim=8",
        "model.encoder_kwargs.unet_kwargs.depth=3",
        "model.encoder_kwargs.unet_kwargs.start_filts=8",
        "model.decoder_pixel_kwargs.output_size=64",
    ]


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    import make_synthetic_city as msc

    root = str(tmp_path_factory.mktemp("torch_gen"))
    msc.main(root, seed=0, density=0.15)
    cfg = compose(default_conf_dir(), overrides=_overrides(root))
    build_dataset(cfg, overwrite=True)
    ds = TomoSARDataset("test", cfg["dataset"], random_sample=False,
                        load_target=False, load_image=False)
    chunks = [{"name": ds.chunk_info[i]["name"], "min_bound": ds.chunk_info[i]["min_bound"],
               "max_bound": ds.chunk_info[i]["max_bound"], "points": ds.data_dic[i]["inputs"]}
              for i in ds.dataset_chunk_idx_ls]
    return root, cfg, ds, chunks


IMAGE_OVERRIDES = ["use_image=true", "model.encoder2_kwargs.depth=3",
                   "model.encoder2_kwargs.start_filts=8",
                   "model.encoder2_kwargs.num_classes=8"]


@pytest.fixture(scope="module")
def image_city(city):
    """The city with its RGB image: the composed config with use_image, the
    raw (3, H, W) image and its raster grid for the port."""
    root, _, _, chunks = city
    cfg = compose(default_conf_dir(), overrides=_overrides(root) + IMAGE_OVERRIDES + [
        f"dataset.satellite_image.folder={root}/raster"])
    reader = RasterReader(f"{root}/raster/rgb.tif")
    data = np.stack([reader.get_data(b) for b in (1, 2, 3)])
    t, (h, w) = reader.T, data.shape[1:]
    raster = RasterData((t.c, t.f + t.e * h), (t.c + t.a * w, t.f), (t.a, -t.e))
    return root, cfg, chunks, (data, raster)


def _fused2_cfg(cfg):
    """The composed config with the fused2 serving path switched on."""
    out = copy.deepcopy(cfg)
    out["model"]["encoder_kwargs"]["sorted_impl"] = "fused2"
    out["dataset"]["points"]["sort"] = True
    return out


def test_scene_patches_match_tomosar_dataset(city):
    _, cfg, ds, chunks = city
    mine = SceneDataset(chunks, cfg["dataset"], "test")
    assert len(mine) == len(ds) == 9
    assert [c["min_bound"][:2] for c in mine.chunk_info_ls] == \
        [c["min_bound"][:2] for c in ds.chunk_info_ls]
    for i in range(len(ds)):
        a, b = mine[i], ds[i]
        assert set(a) <= set(b)  # the JAX patch also carries its transform
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("random_sample", [False, True])
def test_image_patches_match_tomosar_dataset(image_city, random_sample):
    """Image crops (normalized, y-up, HWC) and, on random anchors, the snap
    to the image pixel grid."""
    _, cfg, chunks, image = image_city
    ref = TomoSARDataset("test", cfg["dataset"], random_sample=random_sample,
                         random_length=6, load_target=False, load_image=True)
    mine = SceneDataset(chunks, cfg["dataset"], "test", random_sample=random_sample,
                        random_length=6, image=image)
    assert len(mine) == len(ref)
    for i in range(len(ref)):
        a = mine.__getitem__(i, np.random.default_rng(i))
        b = ref.__getitem__(i, np.random.default_rng(i))
        assert "image" in a and a["image"].shape == (128, 128, 3)
        assert set(a) <= set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert a["image"].dtype == b["image"].dtype == np.float32


@pytest.mark.parametrize("aligned", [True, False])
def test_loader_batches_match(city, aligned):
    _, cfg, ds, chunks = city
    sort_reso = 64 if aligned else None
    mine = PatchLoader(SceneDataset(chunks, cfg["dataset"], "test"), 2, [BUCKET],
                       fixed_bucket=BUCKET, sort_reso=sort_reso)
    ref = JaxPatchLoader(ds, 2, [BUCKET], fixed_bucket=BUCKET, sort_reso=sort_reso,
                         aligned=aligned)
    n = 0
    for a, b in zip(mine, ref):
        n += 1
        keys = set(b) - {"name"}
        assert keys <= set(a)
        for k in keys:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert a["name"] == b["name"]
    assert n == len(ref) == 5


def test_generated_raster_matches_jax(city, tmp_path):
    import jax.numpy as jnp

    from tomosar2height_tpu.infer import DSMGenerator as JaxDSMGenerator
    from tomosar2height_tpu.models import build_model as jax_build_model

    _, cfg, ds, chunks = city
    jloader = JaxPatchLoader(ds, 2, [BUCKET], fixed_bucket=BUCKET)
    jmodel = jax_build_model(cfg)
    sample = jloader.collate([ds[0]])
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(sample["points"]),
                         jnp.asarray(sample["point_mask"]))
    dsm = cfg["dsm_generation"]
    jgen = JaxDSMGenerator(jmodel, lambda: params, jloader, dsm["pixel_size"],
                           half_blend_percent=dsm.get("half_blend_percent"),
                           crs_epsg=dsm.get("crs_epsg"), use_cloud=True,
                           use_image=False)
    jgen.generate_dsm(str(tmp_path / "jax.tif"))

    pcfg = _fused2_cfg(cfg)
    model = load_flax_params(build_model(pcfg, device="cpu"),
                             jax.tree.map(np.asarray, params)).eval()
    gen = make_generator(model, pcfg, chunks)
    assert gen.data_loader.sort_reso == 64
    gen.generate_dsm(str(tmp_path / "port.tif"))
    assert gen.last_stats["n_patches"] == 9

    a, b = RasterReader(str(tmp_path / "port.tif")), RasterReader(str(tmp_path / "jax.tif"))
    assert a.shape == b.shape == (320, 320)
    assert a.T == b.T
    da, db = a.get_data(), b.get_data()
    nan = np.isnan(db)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(da), nan)
    z = cfg["dataset"]["normalize"]["z_bound"]
    np.testing.assert_allclose(da[~nan], db[~nan], rtol=0, atol=2e-4 * (z[1] - z[0]))
    assert (da[~nan] >= 0).all()


def test_generated_image_raster_matches_jax(image_city, tmp_path):
    """The cloud+image network serves the same raster in both packages: the
    JAX plain path against the port's fused2 path with fused_convs and
    fused_head set (their plain versions here)."""
    import jax.numpy as jnp

    from tomosar2height_tpu.infer import DSMGenerator as JaxDSMGenerator
    from tomosar2height_tpu.models import build_model as jax_build_model

    _, cfg, chunks, image = image_city
    ds = TomoSARDataset("test", cfg["dataset"], random_sample=False, load_target=False,
                        load_image=True)
    jloader = JaxPatchLoader(ds, 2, [BUCKET], fixed_bucket=BUCKET)
    jmodel = jax_build_model(cfg)
    sample = jloader.collate([ds[0]])
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(sample["points"]),
                                  jnp.asarray(sample["point_mask"]),
                                  jnp.asarray(sample["image"]))
    params = jax.tree.map(np.asarray, params)
    dsm = cfg["dsm_generation"]
    jgen = JaxDSMGenerator(jmodel, lambda: params, jloader, dsm["pixel_size"],
                           half_blend_percent=dsm.get("half_blend_percent"),
                           crs_epsg=dsm.get("crs_epsg"), use_cloud=True, use_image=True)
    jgen.generate_dsm(str(tmp_path / "jax.tif"))

    pcfg = _fused2_cfg(cfg)
    pcfg["model"]["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = True
    pcfg["model"]["encoder2_kwargs"]["fused_convs"] = True
    pcfg["model"]["decoder_pixel_kwargs"]["fused_head"] = True
    model = load_flax_params(build_model(pcfg, device="cpu"), params).eval()
    gen = make_generator(model, pcfg, chunks, image=image)
    gen.generate_dsm(str(tmp_path / "port.tif"))
    assert gen.use_image and gen.last_stats["n_patches"] == 9

    a, b = RasterReader(str(tmp_path / "port.tif")), RasterReader(str(tmp_path / "jax.tif"))
    assert a.shape == b.shape and a.T == b.T
    da, db = a.get_data(), b.get_data()
    nan = np.isnan(db)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(da), nan)
    z = cfg["dataset"]["normalize"]["z_bound"]
    np.testing.assert_allclose(da[~nan], db[~nan], rtol=0, atol=2e-4 * (z[1] - z[0]))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_flagship_literal_matches_compose():
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=berlin", "dataset.points.sort=true",
        "model.encoder_kwargs.sorted_impl=fused2"])
    for path, value in _leaves(flagship_config()):
        node = cfg
        for k in path:
            node = node[k]
        assert node == value, path


def test_fusion_literal_matches_compose():
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=berlin", "use_image=true", "dataset.points.sort=true",
        "model.encoder_kwargs.sorted_impl=fused2",
        "model.encoder_kwargs.unet_kwargs.fused_convs=true",
        "model.encoder2_kwargs.fused_convs=true",
        "model.decoder_pixel_kwargs.fused_head=true"])
    mine = fusion_config()
    assert cfg["use_footprint"] is False and mine["use_image"] is True
    for path, value in _leaves(mine):
        node = cfg
        for k in path:
            node = node[k]
        assert node == value, path
