"""Affine-georeferenced rasters (host, numpy): the scene raster the
generator fills, the GeoTIFFs a dataset reads, and their writer.

Counterpart of ``tomosar2height_tpu/geo/raster.py`` (``RasterData``,
``RasterReader``, ``RasterWriter.write_to_file``) on the codec of
:mod:`tomosar2height_tpu_torch.geo.tiff`: bands 1-indexed, ``T``/``T_inv``,
col/row and value queries with floor semantics, windowed reads. A written
file's bytes are the JAX writer's for what the port writes: 1 or 3
north-up float32 bands, uncompressed strips of about 1 MiB, the
ModelPixelScale/ModelTiepoint/GeoKeyDirectory tags; a raster whose data would
pass classic TIFF's 32-bit offsets is written as BigTIFF.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from tomosar2height_tpu_torch.geo.tiff import read_tiff
from tomosar2height_tpu_torch.geo.transform import Affine

_CLASSIC_OFFSET_LIMIT = 1 << 32  # tests shrink it to reach the BigTIFF branch
# TIFF field types: SHORT, LONG, DOUBLE, LONG8 (BigTIFF)
_FMT = {3: "H", 4: "I", 12: "d", 16: "Q"}


def cal_dsm_shape(bl_bound, tr_bound, pixel_size) -> Tuple[int, int]:
    """(rows, cols) of the raster covering the bbox at the pixel size."""
    bl = np.asarray(bl_bound, dtype=np.float64)
    tr = np.asarray(tr_bound, dtype=np.float64)
    ps = np.asarray(pixel_size, dtype=np.float64)
    return math.floor((tr[1] - bl[1]) / ps[1]), math.floor((tr[0] - bl[0]) / ps[0])


class RasterData:
    """A multi-band raster (each band (H, W), 1-indexed) with an affine
    geo-transform ``T``. Built from a bbox, ``RasterData(bl_bound, tr_bound,
    pixel_size, crs_epsg)`` is north-up: ``x = a*col + c``, ``y = e*row + f``
    with ``(a, b, c, d, e, f) = transform`` and e < 0."""

    def __init__(self, bl_bound=None, tr_bound=None, pixel_size=None,
                 crs_epsg: Optional[int] = None):
        self._bands: Dict[int, np.ndarray] = {}
        self._grid: Tuple[Optional[int], Optional[int]] = (None, None)
        self.T: Optional[Affine] = None
        self.T_inv: Optional[Affine] = None
        self.pixel_size = None
        self.crs_epsg: Optional[int] = None
        if bl_bound is not None:
            self.set_transform(bl_bound, tr_bound, pixel_size, crs_epsg)

    def set_transform(self, bl_bound, tr_bound, pixel_size, crs_epsg=None) -> None:
        """North-up transform from the bottom-left and top-right bounds."""
        self.pixel_size = list(np.asarray(pixel_size, dtype=np.float64))
        self.T = Affine(self.pixel_size[0], 0.0, float(bl_bound[0]),
                        0.0, -self.pixel_size[1], float(tr_bound[1]))
        self.T_inv = ~self.T
        self.crs_epsg = int(crs_epsg) if crs_epsg is not None else None
        self._grid = cal_dsm_shape(bl_bound, tr_bound, pixel_size)

    @property
    def transform(self) -> Tuple[float, ...]:
        return self.T.coefficients()

    @property
    def shape(self) -> Tuple[Optional[int], Optional[int]]:
        """(rows, cols): the bands', or the bbox's before any band is set."""
        band = next(iter(self._bands.values()), None)
        return tuple(band.shape) if band is not None else self._grid

    @property
    def count(self) -> int:
        return len(self._bands)

    # -- bands -------------------------------------------------------------------

    def get_data(self, band: int = 1) -> Optional[np.ndarray]:
        """A copy of a band's array (None if it is not set)."""
        out = self._bands.get(band)
        return out.copy() if out is not None else None

    def set_data(self, data, band: int = 1) -> None:
        """Set a band; its shape must be the other bands'."""
        data = np.asarray(data)
        others = [v.shape for k, v in self._bands.items() if k != band]
        if others and others[0] != data.shape:
            raise ValueError(f"band {band}: shape {data.shape}, the raster's {others[0]}")
        self._bands[band] = data

    @property
    def data(self) -> Optional[np.ndarray]:
        """Band 1 itself (not a copy)."""
        return self._bands.get(1)

    @data.setter
    def data(self, value) -> None:
        self.set_data(value, 1)

    # -- queries -------------------------------------------------------------------

    def query_col_row(self, x: float, y: float) -> Tuple[int, int]:
        """World (x, y) -> (col, row) of the pixel that holds it."""
        t = self.T_inv
        return (math.floor(t.a * x + t.b * y + t.c), math.floor(t.d * x + t.e * y + t.f))

    def query_col_rows(self, xy_arr: np.ndarray):
        """Vectorized :meth:`query_col_row`: (cols, rows) int arrays."""
        cr = np.floor(self.T_inv.apply(np.asarray(xy_arr, dtype=np.float64))).astype(int)
        return cr[:, 0], cr[:, 1]

    def is_in(self, col, row, band: int = 1):
        """Whether (col, row) lies on the band (scalars or arrays)."""
        h, w = self._bands[band].shape
        if isinstance(col, (int, np.integer)) and isinstance(row, (int, np.integer)):
            return bool(0 <= row < h and 0 <= col < w)
        col, row = np.asarray(col), np.asarray(row)
        return (0 <= row) & (row < h) & (0 <= col) & (col < w)

    def query_value(self, x: float, y: float, band: int = 1):
        col, row = self.query_col_row(x, y)
        return self._bands[band][row, col] if self.is_in(col, row, band) else None

    def query_values(self, xy_arr: np.ndarray, band: int = 1, outer_value=-99999):
        """Values at (N, 2) world points; ``outer_value`` off the raster."""
        cols, rows = self.query_col_rows(xy_arr)
        data = self._bands[band]
        inside = self.is_in(cols, rows, band)
        out = np.full(len(cols), outer_value, dtype=data.dtype)
        out[inside] = data[rows[inside], cols[inside]]
        return out

    # -- writing -------------------------------------------------------------------

    def write_to_file(self, filename: str) -> None:
        """Write the 1 or 3 bands as float32 GeoTIFF samples."""
        bands = [self._bands[b] for b in sorted(self._bands)]
        write_geotiff(filename, bands[0] if len(bands) == 1 else np.stack(bands),
                      self.transform, self.crs_epsg)


class RasterReader(RasterData):
    """Every band of a GeoTIFF, read into memory at construction."""

    def __init__(self, tiff_file: str):
        super().__init__()
        self.tiff_file = tiff_file
        data, info = read_tiff(tiff_file)
        self._bands = {i + 1: data[i] for i in range(data.shape[0])}
        self.T = Affine(*info.transform)
        self.T_inv = ~self.T
        self.pixel_size = [self.T.a, -self.T.e]
        self.crs_epsg = info.crs_epsg
        self.nodata = info.nodata

    @property
    def height(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1]

    def index(self, x: float, y: float) -> Tuple[int, int]:
        """(row, col) of the pixel that holds (x, y), as rasterio's ``index``."""
        col, row = self.query_col_row(x, y)
        return row, col

    def read_window(self, row_slice, col_slice, band: int = 1) -> np.ndarray:
        """A copy of ``band[r0:r1, c0:c1]``."""
        return self._bands[band][row_slice[0]:row_slice[1], col_slice[0]:col_slice[1]].copy()


def write_geotiff(path: str, data: np.ndarray, transform,
                  crs_epsg: Optional[int] = None) -> None:
    """Write (H, W) or (3, H, W) data as little-endian float32 GeoTIFF bands,
    pixel-interleaved; BigTIFF where the file would pass 4 GiB. ``transform``
    is (a, 0, c, 0, e, f)."""
    arr = np.asarray(data, dtype="<f4")
    arr = arr[None] if arr.ndim == 2 else arr
    count, height, width = arr.shape
    if count not in (1, 3):
        raise ValueError(f"1 or 3 bands are written, not {count}")
    arr = np.ascontiguousarray(np.moveaxis(arr, 0, -1))  # (H, W, C): no copy of one band
    rowbytes = width * count * 4
    rps = max(1, min(height, (1 << 20) // max(rowbytes, 1)))
    nstrips = (height + rps - 1) // rps
    counts = [min(rps, height - s * rps) * rowbytes for s in range(nstrips)]
    # 64 KiB bounds the header, IFD and tag data
    bigtiff = arr.nbytes + 65536 >= _CLASSIC_OFFSET_LIMIT
    a, b, c, d, e, f = transform
    if b != 0.0 or d != 0.0:
        raise ValueError(f"only north-up transforms are written: {transform}")

    off_typ = 16 if bigtiff else 4
    tags = [(256, 4, [width]), (257, 4, [height]), (258, 3, [32] * count), (259, 3, [1]),
            (262, 3, [2 if count == 3 else 1]), (273, off_typ, [0] * nstrips),
            (277, 3, [count]), (278, 4, [rps]), (279, 4, counts), (284, 3, [1]),
            (339, 3, [3] * count), (33550, 12, [abs(a), abs(e), 0.0]),
            (33922, 12, [0.0, 0.0, 0.0, c, f, 0.0])]
    if crs_epsg is not None:  # projected, pixel-is-area, EPSG code
        tags.append((34735, 3, [1, 1, 0, 3, 1024, 0, 1, 1, 1025, 0, 1, 1,
                                3072, 0, 1, int(crs_epsg)]))
    if bigtiff:
        header = struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16)
        cnt_fmt, cap, ifd_size = "Q", 8, 8 + 20 * len(tags) + 8
    else:
        header = struct.pack("<2sHI", b"II", 42, 8)
        cnt_fmt, cap, ifd_size = "I", 4, 2 + 12 * len(tags) + 4
    blob_off = len(header) + ifd_size
    sizes = [len(v) * struct.calcsize(_FMT[t]) for _, t, v in tags]
    pos = blob_off + sum(s for s in sizes if s > cap)
    offsets = []
    for n in counts:
        offsets.append(pos)
        pos += n
    tags[5] = (273, off_typ, offsets)

    ifd = bytearray(header + struct.pack("<" + ("Q" if bigtiff else "H"), len(tags)))
    blob = bytearray()
    for tag, typ, vals in tags:
        raw = struct.pack("<" + _FMT[typ] * len(vals), *vals)
        ifd += struct.pack("<HH" + cnt_fmt, tag, typ, len(vals))
        if len(raw) <= cap:
            ifd += raw.ljust(cap, b"\0")
        else:
            ifd += struct.pack("<" + cnt_fmt, blob_off + len(blob))
            blob += raw
    ifd += struct.pack("<" + cnt_fmt, 0)  # no next IFD
    with open(path, "wb") as fh:
        fh.write(ifd + blob)
        arr.tofile(fh)
