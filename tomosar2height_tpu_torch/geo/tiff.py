"""The GeoTIFF reader (host, numpy): counterpart of
``tomosar2height_tpu/geo/tiff.py``'s reader, with the same decoding.

Reader: classic TIFF (II/MM) and BigTIFF (magic 43), strips and tiles,
PlanarConfiguration 1 and 2, compression none (1), LZW (5), deflate (8,
32946) and PackBits (32773), the horizontal (2) and floating-point (3)
predictors, u/int 8/16/32 and float32/64 samples, one or more bands, and the
GeoTIFF tags: ModelPixelScale (33550), ModelTiepoint (33922),
ModelTransformation (34264), GeoKeyDirectory (34735, the EPSG code) and
GDAL_NODATA (42113). The writer is
:func:`tomosar2height_tpu_torch.geo.raster.write_geotiff`.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# --- TIFF constants -------------------------------------------------------------

_TYPE_FMT = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL
    6: ("b", 1),   # SBYTE
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    10: ("ii", 8),  # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8 (BigTIFF)
    18: ("Q", 8),  # IFD8 (BigTIFF)
}

TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GDAL_NODATA = 42113

GEOKEY_GEOGRAPHIC_TYPE = 2048
GEOKEY_PROJECTED_CS_TYPE = 3072


@dataclass
class TiffInfo:
    """Parsed raster metadata."""

    width: int = 0
    height: int = 0
    count: int = 1
    dtype: np.dtype = np.dtype(np.float32)
    crs_epsg: Optional[int] = None
    nodata: Optional[float] = None
    # geotransform coefficients (a, b, c, d, e, f): x = a*col + b*row + c
    transform: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    tags: Dict[int, tuple] = field(default_factory=dict)


# --- decompressors ---------------------------------------------------------------


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
        # 128 == no-op
    return bytes(out)


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early code-size change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset_table():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset_table()
    bitbuf, bitcnt = 0, 0
    code_size = 9
    prev: Optional[bytes] = None
    pos, n = 0, len(data)
    while True:
        while bitcnt < code_size and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        if bitcnt < code_size:
            break
        code = (bitbuf >> (bitcnt - code_size)) & ((1 << code_size) - 1)
        bitcnt -= code_size
        if code == EOI:
            break
        if code == CLEAR:
            reset_table()
            code_size = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF uses "early change": bump size when next append would overflow
        if len(table) + 1 >= (1 << code_size) and code_size < 12:
            code_size += 1
        if len(out) >= expected:
            break
    return bytes(out)


def _decompress(data: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return data
    if compression in (8, 32946):
        return zlib.decompress(data)
    if compression == 5:
        return _lzw_decode(data, expected)
    if compression == 32773:
        return _packbits_decode(data, expected)
    raise NotImplementedError(f"TIFF compression {compression} not supported")


def _undo_predictor(arr: np.ndarray, predictor: int, dtype: np.dtype, samples: int) -> np.ndarray:
    """Undo horizontal (2) or floating-point (3) predictor on a (rows, cols*samples) byte plane."""
    if predictor == 2:
        a = arr.view(dtype).reshape(arr.shape[0], -1, samples)
        np.cumsum(a, axis=1, dtype=a.dtype, out=a)
        return a.reshape(arr.shape[0], -1).view(np.uint8)
    if predictor == 3:
        # fp predictor: per row, bytes were split into dtype.itemsize streams then diffed
        rows, rowbytes = arr.shape
        itemsize = dtype.itemsize
        ncols = rowbytes // itemsize
        a = np.cumsum(arr.astype(np.uint8), axis=1, dtype=np.uint8)
        # reassemble: stream i holds byte i (big-endian order) of each value
        split = a.reshape(rows, itemsize, ncols)
        be = np.empty((rows, ncols, itemsize), dtype=np.uint8)
        for i in range(itemsize):
            be[:, :, i] = split[:, i, :]
        return be.reshape(rows, rowbytes)
    return arr


# --- reader ----------------------------------------------------------------------


class TiffFile:
    """Reads the first IFD of a classic TIFF into numpy arrays (all bands)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        self.info = TiffInfo()
        self._parse()

    # parsing helpers
    def _parse(self):
        buf = self._buf
        bo = buf[:2]
        if bo == b"II":
            self._e = "<"
        elif bo == b"MM":
            self._e = ">"
        else:
            raise ValueError(f"Not a TIFF file: {self.path}")
        magic = struct.unpack(self._e + "H", buf[2:4])[0]
        if magic == 43:  # BigTIFF: u16 offset size (must be 8), u16 pad, u64 IFD offset
            osize, pad = struct.unpack(self._e + "HH", buf[4:8])
            if osize != 8 or pad != 0:
                raise ValueError(f"Bad BigTIFF header (offset size {osize})")
            self._big = True
            ifd_off = struct.unpack(self._e + "Q", buf[8:16])[0]
        elif magic == 42:
            self._big = False
            ifd_off = struct.unpack(self._e + "I", buf[4:8])[0]
        else:
            raise ValueError(f"Bad TIFF magic {magic}")
        self._tags = self._read_ifd(ifd_off)
        self._interpret()

    def _read_ifd(self, off: int) -> Dict[int, tuple]:
        buf, e = self._buf, self._e
        # BigTIFF IFDs: u64 entry count, 20-byte entries (u64 count, 8 inline
        # bytes), u64 next-IFD; classic: u16 / 12-byte (u32 count, 4 inline) / u32
        if self._big:
            n = struct.unpack(e + "Q", buf[off:off + 8])[0]
            ent_size, hdr, cnt_fmt, inline_cap = 20, 8, "Q", 8
        else:
            n = struct.unpack(e + "H", buf[off:off + 2])[0]
            ent_size, hdr, cnt_fmt, inline_cap = 12, 2, "I", 4
        tags: Dict[int, tuple] = {}
        for i in range(n):
            ent = buf[off + hdr + ent_size * i: off + hdr + ent_size * (i + 1)]
            tag, typ, cnt = struct.unpack(e + "HH" + cnt_fmt, ent[:4 + struct.calcsize(cnt_fmt)])
            if typ not in _TYPE_FMT:
                continue
            fmt, size = _TYPE_FMT[typ]
            total = size * cnt
            val_field = ent[ent_size - inline_cap:]
            if total <= inline_cap:
                raw = val_field
            else:
                data_off = struct.unpack(e + cnt_fmt, val_field)[0]
                raw = buf[data_off: data_off + total]
            if typ == 2:
                tags[tag] = (raw[:cnt].split(b"\0")[0].decode("ascii", "replace"),)
            elif typ in (5, 10):
                vals = struct.unpack(e + ("I" if typ == 5 else "i") * (2 * cnt), raw[:total])
                tags[tag] = tuple(vals[2 * j] / max(vals[2 * j + 1], 1) for j in range(cnt))
            else:
                tags[tag] = struct.unpack(e + fmt * cnt, raw[:total])
        return tags

    def _tag(self, tag: int, default=None):
        v = self._tags.get(tag)
        return v if v is not None else default

    def _interpret(self):
        t = self.info
        t.tags = self._tags
        t.width = self._tag(TAG_IMAGE_WIDTH, (0,))[0]
        t.height = self._tag(TAG_IMAGE_LENGTH, (0,))[0]
        t.count = self._tag(TAG_SAMPLES_PER_PIXEL, (1,))[0]
        bits = self._tag(TAG_BITS_PER_SAMPLE, (8,))[0]
        sfmt = self._tag(TAG_SAMPLE_FORMAT, (1,))[0]
        key = (sfmt, bits)
        dtype_map = {
            (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
            (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
            (3, 32): np.float32, (3, 64): np.float64,
        }
        if key not in dtype_map:
            raise NotImplementedError(f"TIFF sample format {sfmt}/{bits} bits")
        t.dtype = np.dtype(dtype_map[key]).newbyteorder(self._e)

        # geotransform
        scale = self._tag(TAG_MODEL_PIXEL_SCALE)
        tie = self._tag(TAG_MODEL_TIEPOINT)
        mt = self._tag(TAG_MODEL_TRANSFORMATION)
        if mt is not None and len(mt) >= 16:
            t.transform = (mt[0], mt[1], mt[3], mt[4], mt[5], mt[7])
        elif scale is not None and tie is not None and len(tie) >= 6:
            sx, sy = scale[0], scale[1]
            i, j, _, x, y, _ = tie[:6]
            t.transform = (sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)

        # EPSG
        gkd = self._tag(TAG_GEO_KEY_DIRECTORY)
        if gkd and len(gkd) >= 4:
            nkeys = gkd[3]
            for k in range(nkeys):
                kid, loc, cnt, val = gkd[4 + 4 * k: 8 + 4 * k]
                if kid in (GEOKEY_PROJECTED_CS_TYPE, GEOKEY_GEOGRAPHIC_TYPE) and loc == 0:
                    t.crs_epsg = int(val)
                    if kid == GEOKEY_PROJECTED_CS_TYPE:
                        break

        nd = self._tag(TAG_GDAL_NODATA)
        if nd:
            try:
                t.nodata = float(str(nd[0]).strip())
            except ValueError:
                pass

    # data reading
    def read(self) -> np.ndarray:
        """Return array of shape (count, height, width)."""
        t = self.info
        comp = self._tag(TAG_COMPRESSION, (1,))[0]
        planar = self._tag(TAG_PLANAR_CONFIG, (1,))[0]
        pred = self._tag(TAG_PREDICTOR, (1,))[0]
        spp = t.count
        itemsize = t.dtype.itemsize

        tiled = TAG_TILE_OFFSETS in self._tags
        if tiled:
            tw = self._tag(TAG_TILE_WIDTH)[0]
            th = self._tag(TAG_TILE_LENGTH)[0]
            offs = self._tag(TAG_TILE_OFFSETS)
            cnts = self._tag(TAG_TILE_BYTE_COUNTS)
            tiles_x = (t.width + tw - 1) // tw
            tiles_y = (t.height + th - 1) // th
            if planar == 1:
                out = np.zeros((t.height, t.width, spp), dtype=t.dtype)
                for idx, (o, c) in enumerate(zip(offs, cnts)):
                    ty, tx = divmod(idx, tiles_x)
                    if ty >= tiles_y:
                        break  # extra planes not supported
                    raw = _decompress(self._buf[o:o + c], comp, th * tw * spp * itemsize)
                    plane = np.frombuffer(raw, dtype=np.uint8)[: th * tw * spp * itemsize]
                    plane = plane.reshape(th, tw * spp * itemsize)
                    if pred in (2, 3):
                        plane = _undo_predictor(plane.copy(), pred, t.dtype, spp)
                    arr = plane.reshape(th, tw, spp, itemsize).view(
                        t.dtype if pred != 3 else np.dtype(t.dtype.base).newbyteorder(">")
                    )
                    arr = arr.reshape(th, tw, spp)
                    y0, x0 = ty * th, tx * tw
                    h = min(th, t.height - y0)
                    w = min(tw, t.width - x0)
                    out[y0:y0 + h, x0:x0 + w] = arr[:h, :w].astype(t.dtype)
                return np.ascontiguousarray(np.moveaxis(out, -1, 0))
            else:  # planar == 2: one plane per band
                out = np.zeros((spp, t.height, t.width), dtype=t.dtype)
                per_band = tiles_x * tiles_y
                for idx, (o, c) in enumerate(zip(offs, cnts)):
                    band, rem = divmod(idx, per_band)
                    ty, tx = divmod(rem, tiles_x)
                    raw = _decompress(self._buf[o:o + c], comp, th * tw * itemsize)
                    plane = np.frombuffer(raw, dtype=np.uint8)[: th * tw * itemsize]
                    plane = plane.reshape(th, tw * itemsize)
                    if pred in (2, 3):
                        plane = _undo_predictor(plane.copy(), pred, t.dtype, 1)
                    arr = plane.view(
                        t.dtype if pred != 3 else np.dtype(t.dtype.base).newbyteorder(">")
                    ).reshape(th, tw)
                    y0, x0 = ty * th, tx * tw
                    h = min(th, t.height - y0)
                    w = min(tw, t.width - x0)
                    out[band, y0:y0 + h, x0:x0 + w] = arr[:h, :w].astype(t.dtype)
                return out

        # strips
        rps = self._tag(TAG_ROWS_PER_STRIP, (t.height,))[0]
        rps = min(rps, t.height)
        offs = self._tag(TAG_STRIP_OFFSETS)
        cnts = self._tag(TAG_STRIP_BYTE_COUNTS)
        if offs is None:
            raise ValueError("TIFF has neither strip nor tile offsets")
        strips_per_band = (t.height + rps - 1) // rps
        if planar == 1:
            rows = []
            for si, (o, c) in enumerate(zip(offs, cnts)):
                nrows = min(rps, t.height - si * rps)
                if nrows <= 0:
                    break
                expected = nrows * t.width * spp * itemsize
                raw = _decompress(self._buf[o:o + c], comp, expected)
                plane = np.frombuffer(raw, dtype=np.uint8)[:expected].reshape(
                    nrows, t.width * spp * itemsize
                )
                if pred in (2, 3):
                    plane = _undo_predictor(plane.copy(), pred, t.dtype, spp)
                arr = plane.reshape(nrows, t.width, spp, itemsize).view(
                    t.dtype if pred != 3 else np.dtype(t.dtype.base).newbyteorder(">")
                ).reshape(nrows, t.width, spp)
                rows.append(arr.astype(t.dtype))
            full = np.concatenate(rows, axis=0)
            return np.ascontiguousarray(np.moveaxis(full, -1, 0))
        else:
            out = np.zeros((spp, t.height, t.width), dtype=t.dtype)
            for idx, (o, c) in enumerate(zip(offs, cnts)):
                band, si = divmod(idx, strips_per_band)
                nrows = min(rps, t.height - si * rps)
                expected = nrows * t.width * itemsize
                raw = _decompress(self._buf[o:o + c], comp, expected)
                plane = np.frombuffer(raw, dtype=np.uint8)[:expected].reshape(nrows, t.width * itemsize)
                if pred in (2, 3):
                    plane = _undo_predictor(plane.copy(), pred, t.dtype, 1)
                arr = plane.view(
                    t.dtype if pred != 3 else np.dtype(t.dtype.base).newbyteorder(">")
                ).reshape(nrows, t.width)
                out[band, si * rps: si * rps + nrows] = arr.astype(t.dtype)
            return out


def read_tiff(path: str) -> Tuple[np.ndarray, TiffInfo]:
    """Read all bands of a (Geo)TIFF: returns ((count, H, W) array, TiffInfo)."""
    tf = TiffFile(path)
    data = tf.read()
    # normalize dtype byte order to native
    data = data.astype(data.dtype.newbyteorder("="))
    return data, tf.info
