"""The port's wires and host side against the JAX package, on the CPU.

- The u16 point wire: ``quantize_points_u16`` and both dequantizers
  bit-equal to JAX's; the loader's u16 batches (the layout built on the
  dequantized coordinates) bit-equal to the JAX loader's, the cell ids the
  model recomputes from them equal to the layout's; the forward on a u16
  batch's points against the JAX forward on the same u16 points (both
  dequantize on their device) at the model's 2e-4 * z_scale.
- The loader's host side: batches with ``n_workers`` 0/1/3 x ``prefetch``
  0/2 bit-equal to each other and to the JAX loader's (det_stream,
  augmentation, the u8 image wire and targets); a fault in the producer is
  raised to the consumer; a consumer that stops early stops the producer.
- The generator's wires on a tiny cloud+image network: the device crop's
  raster bit-equal to the host crop's (f32 and u8 wires); the u8 wire's
  within 1e-4 m of the f32 wire's (JAX ``tests/test_sharded_infer.py``);
  the f16 raster wire equal to the f32 run's tiles rounded through f16 and
  within 2^-11 of the heights of the f32 raster, NaN masks equal;
  ``wire_cells='host'`` and the worker pool bit-equal to the defaults.
- The trainer's wires: ``wire_cells='host'`` gives the loss of ``'device'``
  (JAX ``tests/test_wire_cells.py:60``), the u8 crops normalized in the step
  the f32 wire's loss within f32 rounding.
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_dataset import H, W, overrides  # noqa: E402
from tomosar2height_tpu import native  # noqa: E402
from tomosar2height_tpu.config import compose as jax_compose  # noqa: E402
from tomosar2height_tpu.config.compose import default_conf_dir as jax_conf_dir  # noqa: E402
from tomosar2height_tpu.data import PatchLoader as JaxPatchLoader  # noqa: E402
from tomosar2height_tpu.data import TomoSARDataset as JaxDataset  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.ops import sorted_scatter as jss  # noqa: E402
from tomosar2height_tpu_torch.data.pipeline import loader_kwargs, prefetch_depth  # noqa: E402
from tomosar2height_tpu_torch.config import compose, default_conf_dir  # noqa: E402
from tomosar2height_tpu_torch.data import PatchLoader, TomoSARDataset, build_dataset  # noqa: E402
from tomosar2height_tpu_torch.data.synthetic import write_city  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterReader  # noqa: E402
from tomosar2height_tpu_torch.infer.generator import DSMGenerator  # noqa: E402
from tomosar2height_tpu_torch.models import build_model, init_weights  # noqa: E402
from tomosar2height_tpu_torch.ops import sorted_scatter as ss  # noqa: E402
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import state_dict_to_flax  # noqa: E402

RESO = 32
TINY = ["model.encoder_kwargs.plane_resolution=32", "model.encoder_kwargs.hidden_dim=8",
        "model.encoder_kwargs.feature_dim=8", "model.encoder_kwargs.unet_kwargs.depth=2",
        "model.encoder_kwargs.unet_kwargs.start_filts=8",
        "model.encoder2_kwargs.depth=2", "model.encoder2_kwargs.start_filts=8",
        "model.encoder2_kwargs.num_classes=8", "model.decoder_pixel_kwargs.hidden_dim=8",
        "model.decoder_pixel_kwargs.output_size=128", "dsm_generation.pixel_size=[1,1]",
        "dataset.points.bucket_sizes=[4096]", "dataset.points.train_bucket=4096",
        "training.val_batch_size=2", "use_footprint=false", "dataset.points.sort=true",
        "model.encoder_kwargs.sorted_impl=fused2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_numpy_patches(monkeypatch):
    monkeypatch.setattr(native, "crop_transform_patch", lambda *a, **k: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wires_city"))
    write_city(root, seed=6, density=0.15, W=W, H=H)
    build_dataset(compose(default_conf_dir(), overrides=overrides(root)))
    return root


def _cfg(root, extra=(), image=True):
    ov = overrides(root) + TINY + [f"use_image={str(image).lower()}"] + list(extra)
    return compose(default_conf_dir(), overrides=ov)


# --- the u16 point wire ---------------------------------------------------------


def test_u16_quantizer_equals_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.0, 1.0, (4000, 3)).astype(np.float32)
    pts[:6, 0] = [0.0, 1.0, 0.5 / 65535, 1.5 / 65535, np.nextafter(np.float32(1), 0), 0.25]
    q = ss.quantize_points_u16(pts)
    np.testing.assert_array_equal(q, jss.quantize_points_u16(pts))
    deq = ss.dequantize_points_np(q)
    np.testing.assert_array_equal(deq, jss.dequantize_points_np(q))
    np.testing.assert_array_equal(ss.dequantize_points(torch.from_numpy(q)).numpy(), deq)
    np.testing.assert_array_equal(np.asarray(jss.dequantize_points(jnp.asarray(q))), deq)
    np.testing.assert_array_equal(ss.quantize_points_u16(deq), q)


@pytest.fixture(scope="module")
def u16_batches(root):
    """The val split's first batch through both loaders on the u16 wire
    (fused2's aligned layout at 32^2)."""
    cfg = _cfg(root, image=False)
    jcfg = jax_compose(jax_conf_dir(), overrides=overrides(root) + TINY + ["use_image=false"])
    kw = dict(bucket_sizes=[4096], fixed_bucket=4096, sort_reso=RESO, aligned=True,
              tile_cells=1024, wire_points="uint16")
    mine = PatchLoader(TomoSARDataset("val", cfg["dataset"], load_image=False), 2, **kw)
    ref = JaxPatchLoader(JaxDataset("val", jcfg["dataset"], load_image=False), 2, **kw)
    return cfg, next(iter(mine)), next(iter(ref))


def test_u16_batches_equal_jax(u16_batches):
    _, a, b = u16_batches
    assert a["points"].dtype == b["points"].dtype == np.uint16
    assert a.keys() == b.keys()
    for k in a:
        if k != "name":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cells = ss.morton_cells_device(ss.dequantize_points(torch.from_numpy(a["points"])),
                                   torch.from_numpy(a["point_mask"]), RESO,
                                   int(ss.PAD_CELL_SENTINEL))
    np.testing.assert_array_equal(cells.numpy(), a["cell"])


def test_u16_needs_the_aligned_layout(root):
    ds = TomoSARDataset("val", _cfg(root, image=False)["dataset"], load_image=False)
    with pytest.raises(ValueError, match="aligned"):
        PatchLoader(ds, 2, [4096], sort_reso=RESO, aligned=False, wire_points="uint16")


def test_u16_forward_matches_jax(u16_batches):
    """The u16 batch's points and mask through both models' plain path
    (no layout passed): each dequantizes the wire itself; the layout's cells
    recomputed from the dequantized points are held above."""
    cfg, batch, _ = u16_batches
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(2))
    params = state_dict_to_flax(model.state_dict())
    pts, mask = batch["points"], batch["point_mask"]
    want = np.asarray(jax.jit(jax_build_model(cfg.to_dict()).apply)(
        params, jnp.asarray(pts), jnp.asarray(mask))[0])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pts), torch.from_numpy(mask))[0].numpy()
    z = cfg["dataset"]["normalize"]["z_bound"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * (z[1] - z[0]))


# --- the loader's host side ------------------------------------------------------


def _train_loaders(root):
    """(port dataset, JAX dataset, loader kwargs): the augmented training
    split with targets and u8 image crops on fused's aligned layout."""
    ov = ["dataset.satellite_image.wire=uint8"]
    cfg = _cfg(root, ov)
    jcfg = jax_compose(jax_conf_dir(), overrides=overrides(root) + TINY + ["use_image=true"]
                       + ov)
    kw = dict(random_sample=True, random_length=8, flip_augm=True, rotate_augm=True)
    lk = dict(bucket_sizes=[4096], fixed_bucket=4096, sort_reso=RESO, aligned=True,
              tile_cells=256, shuffle=True, drop_last=True, seed=3, det_stream=True)
    return (TomoSARDataset("train", cfg["dataset"], **kw),
            JaxDataset("train", jcfg["dataset"], **kw), lk)


@pytest.fixture(scope="module")
def reference_epochs(root):
    mine, ref, lk = _train_loaders(root)
    loader = JaxPatchLoader(ref, 2, **lk)
    return mine, lk, [list(loader) for _ in range(2)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k == "name":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("prefetch_depth", [0, 2])
@pytest.mark.parametrize("n_workers", [0, 1, 3])
def test_loader_batches_equal_jax(reference_epochs, n_workers, prefetch_depth):
    mine, lk, want = reference_epochs
    loader = PatchLoader(mine, 2, n_workers=n_workers, prefetch=prefetch_depth, **lk)
    for epoch in want:
        got = list(loader)
        _assert_batches_equal(got, epoch)
        assert got[0]["image"].dtype == np.uint8


class _Faulty:
    """A serving dataset whose third patch raises."""
    random_sample = False

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == 2:
            raise OSError("disk gone")
        return self.ds[i]


def test_prefetch_raises_the_producers_fault(root):
    ds = TomoSARDataset("vis", _cfg(root, image=False)["dataset"], load_image=False,
                        load_target=False)
    for workers in (0, 2):
        loader = PatchLoader(_Faulty(ds), 1, [4096], prefetch=2, n_workers=workers)
        with pytest.raises(OSError, match="disk gone"):
            list(loader)


def test_prefetch_stops_with_its_consumer(root):
    ds = TomoSARDataset("vis", _cfg(root, image=False)["dataset"], load_image=False,
                        load_target=False)
    loader = PatchLoader(ds, 1, [4096], prefetch=1, n_workers=2)
    it = iter(loader)
    next(it)
    it.close()
    gc.collect()
    assert not [t for t in threading.enumerate() if t.name == "PatchLoader-prefetch"]


def test_cli_reads_the_loader_keys(root):
    cfg = _cfg(root, ["dataloader.n_workers=3", "dataset.points.wire=uint16"])
    kw = loader_kwargs(cfg)
    assert (kw["n_workers"], kw["wire_points"], prefetch_depth(cfg)) == (3, "uint16", 2)
    assert prefetch_depth(_cfg(root, ["dataloader.prefetch=0"])) == 0
    assert prefetch_depth({"dataloader": {}}) == prefetch_depth({}) == 2


# --- the generator's wires -----------------------------------------------------


@pytest.fixture(scope="module")
def fusion(root):
    cfg = _cfg(root)
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(5))
    return cfg, model.eval()


def _raster(root, fusion, tmp_path, extra=(), tag="r", **gen_kw):
    cfg = _cfg(root, extra)
    model = fusion[1]
    ds = TomoSARDataset("test", cfg["dataset"], load_target=False)
    loader = PatchLoader(ds, 2, **{**loader_kwargs(cfg), "prefetch": prefetch_depth(cfg)})
    dsm = cfg["dsm_generation"]
    gen = DSMGenerator(model, loader, dsm["pixel_size"], dsm.get("half_blend_percent"),
                       dsm.get("crs_epsg"), use_image=True, **gen_kw)
    path = str(tmp_path / f"{tag}.tif")
    gen.generate_dsm(path)
    return RasterReader(path).get_data(), gen


@pytest.fixture(scope="module")
def host_raster(root, fusion, tmp_path_factory):
    return _raster(root, fusion, tmp_path_factory.mktemp("host"),
                   ["dataloader.prefetch=0"])[0]


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_device_crop_raster_equals_host_crop(root, fusion, host_raster, tmp_path, wire):
    wires = [f"dataset.satellite_image.wire={wire}"]
    got, gen = _raster(root, fusion, tmp_path, wires + ["dataset.satellite_image.crop=device"])
    assert gen._device_image
    ref = host_raster if wire == "float32" else _raster(root, fusion, tmp_path, wires,
                                                        "host8")[0]
    np.testing.assert_array_equal(got, ref)


def test_u8_raster_matches_f32(root, fusion, host_raster, tmp_path):
    got, gen = _raster(root, fusion, tmp_path, ["dataset.satellite_image.wire=uint8"])
    assert gen._image_norm is not None
    nan = np.isnan(host_raster)
    assert nan.sum() < nan.size
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], host_raster[~nan], atol=1e-4, rtol=0)


def test_f16_raster_is_the_f32_tiles_rounded(root, fusion, host_raster, tmp_path, monkeypatch):
    got, gen = _raster(root, fusion, tmp_path, tag="f16", wire_dtype="float16")
    nan = np.isnan(host_raster)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = max(1.0, float(np.abs(host_raster[~nan]).max()))
    np.testing.assert_allclose(got[~nan], host_raster[~nan], atol=scale * 2.0 ** -11, rtol=0)
    # the f32 run with each tile rounded through f16 on the card gives the same bits
    forward = DSMGenerator._forward_impl
    monkeypatch.setattr(DSMGenerator, "_forward_impl",
                        lambda self, *a: forward(self, *a).half().float())
    rounded, _ = _raster(root, fusion, tmp_path, tag="rounded")
    np.testing.assert_array_equal(got, rounded)


def test_host_cells_and_workers_give_the_same_raster(root, fusion, host_raster, tmp_path):
    got, _ = _raster(root, fusion, tmp_path, ["dataloader.n_workers=3"], tag="pool",
                     wire_cells="host")
    np.testing.assert_array_equal(got, host_raster)


# --- the trainer's wires -------------------------------------------------------


def test_trainer_wires(root, fusion):
    """wire_cells 'host' and 'device' give one loss; u8 crops normalized in
    the step give the f32 wire's loss within f32 rounding."""
    model = fusion[1]
    losses = {}
    for wire in ("float32", "uint8"):
        cfg = _cfg(root, [f"dataset.satellite_image.wire={wire}"])
        ds = TomoSARDataset("val", cfg["dataset"])
        batch = next(iter(PatchLoader(ds, 2, **loader_kwargs(cfg))))
        assert batch["image"].dtype == np.dtype(wire)
        for cells in ("device", "host"):
            trainer = Trainer(model, {"optimize_every": 1, "wire_cells": cells},
                              use_image=True, image_norm=ds.image_norm)
            prepared = trainer.prepare_batch(batch)
            assert ("cell" in prepared) == (cells == "host")
            with torch.no_grad():
                losses[wire, cells] = float(trainer.loss(prepared)[0])
    assert losses["float32", "host"] == losses["float32", "device"]
    assert losses["uint8", "host"] == losses["uint8", "device"]
    np.testing.assert_allclose(losses["uint8", "host"], losses["float32", "host"], rtol=1e-5)
