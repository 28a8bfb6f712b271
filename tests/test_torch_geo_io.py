"""The port's geo file I/O against the JAX package's: ``read_tiff`` of files
written by the JAX writer, by PIL (libtiff) and by a tiled writer here, each
compression (none, LZW, deflate, PackBits) and predictor (2, 3), u8/i16/f32,
1 and 3 bands, strips and tiles, both byte orders, BigTIFF: every array
exactly equal to JAX's read and to the data written; ``RasterReader``'s
attributes and queries; the writer's bytes for what the port writes (1 or 3
float32 bands, classic and BigTIFF); LAS and PLY written by either
package read bit-equal by the other; ``dilate_mask``."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest

from tomosar2height_tpu import geo as jgeo
from tomosar2height_tpu.geo import cloud as jcloud
from tomosar2height_tpu.geo.tiff import read_tiff as jax_read_tiff
from tomosar2height_tpu.geo.tiff import write_tiff as jax_write_tiff
from tomosar2height_tpu_torch import geo
from tomosar2height_tpu_torch.geo import raster as graster
from tomosar2height_tpu_torch.geo.tiff import read_tiff

TRANSFORM = (0.5, 0.0, 691000.0, 0.0, -0.5, 5336536.0)


def _data(rng, dtype, count, h=37, w=53):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        a = rng.normal(10, 30, (count, h, w)).astype(dtype)
        a[:, :3, :4] = np.nan
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, int(info.max) + 1, (count, h, w)).astype(dtype)
    return a


def _check(path, want, epsg=None, transform=None):
    mine, info = read_tiff(path)
    ref, rinfo = jax_read_tiff(path)
    assert mine.dtype == ref.dtype == want.dtype and mine.shape == want.shape
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, want)
    for key in ("width", "height", "count", "crs_epsg", "nodata", "transform"):
        assert getattr(info, key) == getattr(rinfo, key), key
    if epsg is not None:
        assert info.crs_epsg == epsg
    if transform is not None:
        assert info.transform == transform


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32"])
@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("compress", [None, "deflate"])
def test_read_jax_written(tmp_path, rng, dtype, count, compress):
    data = _data(rng, dtype, count, h=700, w=400)  # several strips
    path = str(tmp_path / "a.tif")
    jax_write_tiff(path, data, transform=TRANSFORM, crs_epsg=25832, compress=compress,
                   dtype=dtype, nodata=-9999.0)
    _check(path, data, 25832, TRANSFORM)


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("bigtiff", [False, True])
def test_writer_bytes_match_jax(tmp_path, rng, monkeypatch, count, bigtiff):
    """What the port writes (1 or 3 float32 bands, classic or BigTIFF) has
    the JAX writer's bytes and reads back exactly."""
    if bigtiff:
        monkeypatch.setattr(graster, "_CLASSIC_OFFSET_LIMIT", 1 << 10)
    data = _data(rng, "float32", count, h=700, w=400)  # several strips
    mine = tmp_path / "mine.tif"
    geo.write_geotiff(str(mine), data if count > 1 else data[0], TRANSFORM, 25832)
    jax_write_tiff(str(tmp_path / "ref.tif"), data, transform=TRANSFORM, crs_epsg=25832,
                   bigtiff=bigtiff)
    assert mine.read_bytes() == (tmp_path / "ref.tif").read_bytes()
    _check(str(mine), data, 25832, TRANSFORM)
    with pytest.raises(ValueError, match="bands"):
        geo.write_geotiff(str(mine), data[:1].repeat(2, 0), TRANSFORM)


def test_read_bigtiff_and_rotated(tmp_path, rng):
    data = _data(rng, "float32", 1)
    jax_write_tiff(str(tmp_path / "big.tif"), data, transform=TRANSFORM, bigtiff=True)
    _check(str(tmp_path / "big.tif"), data, transform=TRANSFORM)
    rotated = (0.5, 0.1, 100.0, 0.2, -0.5, 200.0)  # ModelTransformation
    jax_write_tiff(str(tmp_path / "rot.tif"), data, transform=rotated)
    _check(str(tmp_path / "rot.tif"), data, transform=rotated)


PIL_CASES = [("L", "raw", None), ("L", "tiff_lzw", None), ("L", "tiff_lzw", 2),
             ("L", "tiff_adobe_deflate", 2), ("L", "packbits", None),
             ("RGB", "tiff_lzw", 2), ("RGB", "packbits", None),
             ("F", "raw", None), ("F", "tiff_lzw", 3), ("F", "tiff_adobe_deflate", 3),
             ("F", "tiff_adobe_deflate", None)]


@pytest.mark.parametrize("mode,compression,predictor", PIL_CASES)
def test_read_pil_written(tmp_path, rng, mode, compression, predictor):
    Image = pytest.importorskip("PIL.Image")
    if mode == "F":
        arr = rng.normal(0, 100, (41, 67)).astype(np.float32)
        want = arr[None]
    elif mode == "L":
        arr = rng.integers(0, 256, (41, 67)).astype(np.uint8)
        want = arr[None]
    else:
        arr = rng.integers(0, 256, (41, 67, 3)).astype(np.uint8)
        want = np.moveaxis(arr, -1, 0)
    path = str(tmp_path / "pil.tif")
    kwargs = {"tiffinfo": {317: predictor}} if predictor else {}
    Image.fromarray(arr, mode=mode).save(path, compression=compression, **kwargs)
    _check(path, want)


def _write_tiled(path, data, tile=(16, 32), compression=1, predictor=1, planar=1,
                 endian="<"):
    """A tiled (Geo)TIFF of (C, H, W) data: the strips' writers cannot make
    one. Predictor 2 differences each sample along the row; 3 shuffles each
    row's big-endian bytes into planes, then differences the bytes."""
    count, h, w = data.shape
    th, tw = tile
    dt = data.dtype.newbyteorder(endian)
    ty, tx = -(-h // th), -(-w // tw)
    pad = np.zeros((count, ty * th, tx * tw), data.dtype)
    pad[:, :h, :w] = data

    def encode(block):  # (th, tw, s)
        if predictor == 2:
            block = block.copy()
            block[:, 1:] = block[:, 1:] - block[:, :-1]
        if predictor == 3:
            b = block.astype(data.dtype.newbyteorder(">")).view(np.uint8)
            b = b.reshape(th, -1, data.dtype.itemsize).transpose(0, 2, 1).reshape(th, -1)
            b = b.copy()
            b[:, 1:] = b[:, 1:] - b[:, :-1]
            raw = b.tobytes()
        else:
            raw = block.astype(dt).tobytes()
        return zlib.compress(raw) if compression == 8 else raw

    blocks = []
    planes = [pad] if planar == 1 else [pad[c:c + 1] for c in range(count)]
    for plane in planes:
        for y in range(ty):
            for x in range(tx):
                blocks.append(encode(np.moveaxis(
                    plane[:, y * th:(y + 1) * th, x * tw:(x + 1) * tw], 0, -1)))
    sfmt = {"f": 3, "i": 2, "u": 1}[data.dtype.kind]
    bits = data.dtype.itemsize * 8
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * count), (259, 3, [compression]),
            (262, 3, [1]), (277, 3, [count]), (284, 3, [planar]), (317, 3, [predictor]),
            (322, 3, [tw]), (323, 3, [th]), (324, 4, [0] * len(blocks)),
            (325, 4, [len(b) for b in blocks]), (339, 3, [sfmt] * count),
            (33550, 12, [2.0, 2.0, 0.0]), (33922, 12, [0.0, 0.0, 0.0, 500.0, 900.0, 0.0]),
            (34735, 3, [1, 1, 0, 1, 3072, 0, 1, 32633])]
    fmt = {3: "H", 4: "I", 12: "d"}
    head = struct.pack(endian + "2sHI", b"II" if endian == "<" else b"MM", 42, 8)
    ifd_len = 2 + 12 * len(tags) + 4
    blob_at = len(head) + ifd_len
    blobs = [struct.pack(endian + fmt[t] * len(v), *v) for _, t, v in tags]
    data_at = blob_at + sum(len(b) for b in blobs if len(b) > 4)
    offsets, pos = [], data_at
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    tags[10] = (324, 4, offsets)
    blobs[10] = struct.pack(endian + "I" * len(offsets), *offsets)
    ifd, extra = bytearray(struct.pack(endian + "H", len(tags))), bytearray()
    for (tag, typ, vals), raw in zip(tags, blobs):
        ifd += struct.pack(endian + "HHI", tag, typ, len(vals))
        if len(raw) <= 4:
            ifd += raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(endian + "I", blob_at + len(extra))
            extra += raw
    ifd += struct.pack(endian + "I", 0)
    with open(path, "wb") as f:
        f.write(head + bytes(ifd) + bytes(extra) + b"".join(blocks))


@pytest.mark.parametrize("dtype,count,compression,predictor,planar,endian", [
    ("uint8", 1, 1, 1, 1, "<"),
    ("uint8", 3, 8, 2, 1, "<"),
    ("uint8", 3, 1, 1, 2, ">"),
    ("int16", 1, 8, 2, 1, ">"),
    ("int16", 3, 8, 2, 2, "<"),
    ("float32", 1, 8, 3, 1, "<"),
    ("float32", 1, 8, 3, 1, ">"),
    ("float32", 3, 1, 1, 2, ">"),
])
def test_read_tiled(tmp_path, rng, dtype, count, compression, predictor, planar, endian):
    data = _data(rng, dtype, count, h=45, w=70)  # partial edge tiles
    path = str(tmp_path / "tiled.tif")
    _write_tiled(path, data, compression=compression, predictor=predictor, planar=planar,
                 endian=endian)
    _check(path, data, 32633, (2.0, 0.0, 500.0, 0.0, -2.0, 900.0))


def test_raster_reader_matches_jax(tmp_path, rng):
    data = _data(rng, "float32", 3, h=60, w=80)
    path = str(tmp_path / "r.tif")
    jax_write_tiff(path, data, transform=TRANSFORM, crs_epsg=25833, nodata=-1.5)
    mine, ref = geo.RasterReader(path), jgeo.RasterReader(path)
    assert mine.T.coefficients() == ref.T.coefficients() == mine.transform
    assert mine.T_inv.coefficients() == ref.T_inv.coefficients()
    assert mine.pixel_size == ref.pixel_size and mine.crs_epsg == ref.crs_epsg == 25833
    assert mine.nodata == ref.nodata == -1.5
    assert (mine.height, mine.width, mine.shape, mine.count) == (
        ref.height, ref.width, ref.shape, ref.count)
    for b in (1, 2, 3):
        np.testing.assert_array_equal(mine.get_data(b), ref.get_data(b))
        np.testing.assert_array_equal(mine.read_window((5, 17), (3, 40), b),
                                      ref.read_window((5, 17), (3, 40), b))
    xy = np.stack([rng.uniform(690990, 691050, 300), rng.uniform(5336500, 5336545, 300)], 1)
    for x, y in xy[:40]:
        assert mine.index(x, y) == tuple(int(v) for v in ref.index(x, y))
        assert mine.query_col_row(x, y) == tuple(int(v) for v in ref.query_col_row(x, y))
        va, vb = mine.query_value(x, y, 2), ref.query_value(x, y, 2)
        assert (va is None and vb is None) or np.array_equal(va, vb, equal_nan=True)
    for got, want in zip(mine.query_col_rows(xy), ref.query_col_rows(xy)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mine.query_values(xy, 3), ref.query_values(xy, 3))
    assert mine.T * (0, 0) == ref.T * (0, 0)


def test_raster_data_writes_as_jax_writer(tmp_path, rng):
    """``set_data``/``get_data``/``write_to_file`` of the scene raster, as the
    entry points use them, give the JAX ``RasterWriter``'s bytes."""
    bl, tr, ps = [1000.0, 5000000.0], [1053.0, 5000074.0], [1.0, 2.0]
    mine = geo.RasterData(bl, tr, ps, 25832)
    ref = jgeo.RasterData()
    ref.set_transform(bl, tr, ps, 25832)
    assert mine.T.coefficients() == ref.T.coefficients()
    assert mine.shape == (37, 53) and mine.get_data() is None
    bands = _data(rng, "float32", 3)
    for b in (1, 2, 3):
        mine.set_data(bands[b - 1], band=b)
        ref.set_data(bands[b - 1], band=b)
        if b == 2:  # the port writes 1 or 3 bands
            continue
        mine.write_to_file(str(tmp_path / "mine.tif"))
        jgeo.RasterWriter(ref).write_to_file(str(tmp_path / "ref.tif"))
        assert (tmp_path / "mine.tif").read_bytes() == (tmp_path / "ref.tif").read_bytes()
    np.testing.assert_array_equal(mine.get_data(2), ref.get_data(2))
    with pytest.raises(ValueError, match="shape"):
        mine.set_data(np.zeros((3, 3)), band=4)


# --- point clouds -----------------------------------------------------------------


@pytest.fixture()
def cloud(rng):
    return np.stack([rng.uniform(690000, 692000, 5000), rng.uniform(5335000, 5337000, 5000),
                     rng.normal(520, 30, 5000)], axis=1)


@pytest.fixture()
def jax_numpy_las(monkeypatch):
    """The JAX package's numpy LAS reader: its C++ reader, where that is
    built, contracts ``x * scale + offset`` into one FMA and so differs from
    its numpy reader by up to 1 ulp; the port reads as the numpy one."""
    from tomosar2height_tpu import native

    monkeypatch.setattr(native, "las_read", lambda path: None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_las_both_ways(tmp_path, cloud, writer):
    path = str(tmp_path / "c.las")
    (geo.save_las if writer == "port" else jcloud.save_las)(path, cloud)
    other = str(tmp_path / "d.las")
    (jcloud.save_las if writer == "port" else geo.save_las)(other, cloud)
    assert open(path, "rb").read() == open(other, "rb").read()
    mine, default = geo.load_las_as_numpy(path), jgeo.load_las_as_numpy(path)
    assert mine.dtype == default.dtype == np.float64
    # one rounding of x * scale more or less: within an ulp of each column's
    # largest magnitude
    assert np.all(np.abs(mine - default) <= np.spacing(np.abs(default).max(axis=0)))
    np.testing.assert_allclose(mine, cloud, atol=6e-4)  # the 1 mm grid


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_las_bit_equal_to_jax_numpy_reader(tmp_path, cloud, writer, jax_numpy_las):
    path = str(tmp_path / "c.las")
    (geo.save_las if writer == "port" else jcloud.save_las)(path, cloud)
    np.testing.assert_array_equal(geo.load_las_as_numpy(path), jgeo.load_las_as_numpy(path))
    np.testing.assert_array_equal(geo.load_pc(path), jgeo.load_pc(path))


def test_las_14_extended_count(tmp_path, cloud, jax_numpy_las):
    """LAS 1.4 with the legacy count 0 reads the 64-bit count."""
    path = tmp_path / "c.las"
    geo.save_las(str(path), cloud)
    raw = bytearray(path.read_bytes())
    raw[25] = 4
    struct.pack_into("<I", raw, 107, 0)
    raw = raw[:247] + struct.pack("<Q", len(cloud)) + raw[255:]
    path.write_bytes(bytes(raw))
    np.testing.assert_array_equal(geo.load_las_as_numpy(str(path)),
                                  jcloud.load_las_as_numpy(str(path)))
    with open(tmp_path / "bad.las", "wb") as f:
        f.write(b"NOTLAS" + bytes(400))
    with pytest.raises(ValueError, match="Not a LAS"):
        geo.load_las_as_numpy(str(tmp_path / "bad.las"))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("colors", [False, True])
def test_ply_both_ways(tmp_path, cloud, rng, writer, colors):
    col = rng.random((len(cloud), 3)) if colors else None
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    (geo.save_pc_to_ply if writer == "port" else jcloud.save_pc_to_ply)(a, cloud, col)
    (jcloud.save_pc_to_ply if writer == "port" else geo.save_pc_to_ply)(b, cloud, col)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(geo.load_ply(a), cloud)
    np.testing.assert_array_equal(jgeo.load_ply(a), geo.load_pc(a))


def test_ascii_ply_and_text_clouds(tmp_path, cloud):
    pts = cloud[:50].tolist()
    lines = ["ply", "format ascii 1.0", "element vertex 50", "property double x",
             "property double y", "property double z", "property uchar red", "end_header"]
    (tmp_path / "a.ply").write_text("\n".join(lines + [f"{x!r} {y!r} {z!r} 7" for x, y, z in pts])
                                    + "\n")
    np.testing.assert_array_equal(geo.load_pc(str(tmp_path / "a.ply")),
                                  jgeo.load_pc(str(tmp_path / "a.ply")))
    pts = np.asarray(pts)
    np.savetxt(tmp_path / "a.xyz", pts)
    np.save(tmp_path / "a.npy", pts)
    np.savez(tmp_path / "a.npz", pts=pts)
    for name in ("a.xyz", "a.npy", "a.npz"):
        np.testing.assert_array_equal(geo.load_pc(str(tmp_path / name)),
                                      jgeo.load_pc(str(tmp_path / name)))
    with pytest.raises(TypeError, match="Unknown"):
        geo.load_pc(str(tmp_path / "a.foo"))


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_dilate_mask_matches_jax(rng, iterations):
    m = rng.random((64, 80)) > 0.97
    got, want = geo.dilate_mask(m.astype(np.float32), iterations), \
        jgeo.dilate_mask(m.astype(np.float32), iterations)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
