"""The port's host geo code and synthetic city against the JAX package's:
point transforms, crops and the grid index, raster pixel origins, GeoTIFF
bytes, and ``build_city``. All bit-identical."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from tomosar2height_tpu import geo as jgeo
from tomosar2height_tpu.geo.tiff import write_tiff
from tomosar2height_tpu_torch import geo
from tomosar2height_tpu_torch.data import synthetic
from tomosar2height_tpu_torch.geo import raster as graster
from tomosar2height_tpu_torch.geo.raster import cal_dsm_shape

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def test_transforms_match(rng):
    m = np.eye(4)
    m[:3, :3] = rng.normal(size=(3, 3))
    m[:3, 3] = rng.normal(size=3) * 1e5
    pts = rng.uniform(0, 1e6, (500, 3))
    np.testing.assert_array_equal(geo.invert_transform(m), jgeo.invert_transform(m))
    np.testing.assert_array_equal(geo.apply_transform(pts, m), jgeo.apply_transform(pts, m))


@pytest.mark.parametrize("n", [0, 3000])
def test_crops_and_grid_index_match(rng, n):
    pts = rng.uniform(0, 1000, (n, 3))
    pts[: n // 10, :2] = np.round(pts[: n // 10, :2], -1)  # points on cell edges
    mine, ref = geo.GridIndex2D(pts, 128.0), jgeo.GridIndex2D(pts, 128.0)
    for lo in [(-50.0, -50.0), (0.0, 0.0), (128.0, 256.0), (300.5, 700.0), (990.0, 990.0)]:
        hi = (lo[0] + 256.0, lo[1] + 256.0)
        a, b = geo.crop_pc_2d(pts, lo, hi), jgeo.crop_pc_2d(pts, lo, hi)
        c, d = mine.query(pts, lo, hi), ref.query(pts, lo, hi)
        for x, y in ((a, b), (c, d), (c, b)):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])


def test_raster_origins_match(rng):
    bl, tr, ps = [691000.0, 5335000.0], [693048.0, 5336536.0], [0.5, 0.5]
    mine = geo.RasterData(bl, tr, ps, 25832)
    ref = jgeo.RasterData()
    ref.set_transform(bl, tr, ps, 25832)
    assert mine.shape == cal_dsm_shape(bl, tr, ps) == jgeo.RasterData.cal_dsm_shape(bl, tr, ps)
    assert mine.transform == ref.T.coefficients()
    for x, y in rng.uniform(bl, tr, (200, 2)):
        assert mine.query_col_row(x, y) == tuple(int(v) for v in ref.query_col_row(x, y))


@pytest.mark.parametrize("rows,cols,epsg,bigtiff", [
    (37, 53, 25832, False),   # one strip
    (700, 600, 25832, False),  # several strips, the last one short
    (37, 53, None, False),     # no CRS
    (37, 53, 25832, True),     # BigTIFF, as past 4 GiB
])
def test_geotiff_bytes_match(tmp_path, rng, monkeypatch, rows, cols, epsg, bigtiff):
    if bigtiff:
        monkeypatch.setattr(graster, "_CLASSIC_OFFSET_LIMIT", 1 << 10)
    raster = geo.RasterData([1000.0, 5000000.0], [1000.0 + cols, 5000000.0 + 2 * rows],
                            [1.0, 2.0], epsg)
    data = rng.normal(10, 5, raster.shape).astype(np.float32)
    data[:5, :7] = np.nan
    geo.write_geotiff(str(tmp_path / "port.tif"), data, raster.transform, epsg)
    write_tiff(str(tmp_path / "jax.tif"), data, transform=raster.transform, crs_epsg=epsg,
               bigtiff=bigtiff)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    back = jgeo.RasterReader(str(tmp_path / "port.tif"))
    np.testing.assert_array_equal(back.get_data(), data)
    assert back.crs_epsg == epsg


def test_build_city_matches_script():
    import make_synthetic_city as msc

    ndsm, pts, rgb = synthetic.build_city(3, density=0.1, n_buildings=6, W=200, H=150)
    ref = msc.build_city(3, density=0.1, n_buildings=6, W=200, H=150)
    np.testing.assert_array_equal(ndsm, ref[0])
    np.testing.assert_array_equal(pts, ref[3])
    assert rgb.dtype == ref[4].dtype
    np.testing.assert_array_equal(rgb, ref[4])
    assert (synthetic.X0, synthetic.Y0) == (msc.X0, msc.Y0)


@pytest.mark.parametrize("n_buildings", [None, 7])
def test_write_city_files_match_script(tmp_path, n_buildings):
    """``write_city``'s files are the script's byte for byte, with the
    script's count of buildings by default; with ``n_buildings`` its scene
    is ``build_city``'s."""
    import make_synthetic_city as msc

    W, H = 160, 96
    got = synthetic.write_city(str(tmp_path / "port"), seed=2, density=0.05, W=W, H=H,
                               n_buildings=n_buildings)
    names = ["raster/ndsm.tif", "raster/footprint.tif", "raster/building_class.tif",
             "raster/rgb.tif", "cloud/city.las"]
    if n_buildings is None:
        assert got["n_buildings"] == 10
        msc.main(str(tmp_path / "ref"), seed=2, density=0.05, width=W, height=H)
        for name in names:
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "ref" / name).read_bytes()), name
    else:
        ndsm, pts, rgb = synthetic.build_city(2, 0.05, n_buildings, W, H)
        np.testing.assert_array_equal(geo.RasterReader(got["ndsm"]).get_data(), ndsm)
        back = geo.RasterReader(got["rgb"])
        np.testing.assert_array_equal(np.stack([back.get_data(b) for b in (1, 2, 3)]), rgb)
        # LAS keeps mm integers: half a mm, plus float64 rounding at 5e6 m
        np.testing.assert_allclose(geo.load_pc(got["cloud"]), pts, rtol=0, atol=5e-4 + 1e-8)
