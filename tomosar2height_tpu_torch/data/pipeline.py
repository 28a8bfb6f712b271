"""Batching + bucketed padding: ragged host patches -> static arrays (numpy).

Counterpart of ``tomosar2height_tpu/data/pipeline.py``. ``PatchLoader``
keeps the JAX loader's batch contract for serving and training: every patch
pads (or subsamples) into a point bucket; with ``sort_reso`` the patch is
Morton-sorted, into the aligned layout (``aligned``, the default here:
points, mask, cells and tile offsets of ``tile_cells``-cell tiles, the batch
trimmed to a 4096-row multiple) or the plain sorted layout (points and mask
reordered, cells with pads at sort_reso**2, per-cell offsets; no trim).
:func:`tile_cells_for_impl` gives the tile size each ``sorted_impl`` reads.
Training adds the epoch shuffle, ``drop_last``, the GT target ``dsm`` and the
deterministic stream (``det_stream``: every batch a pure function of seed,
epoch and position). The rng draws are the JAX loader's, so both loaders give
identical batches for one dataset; :meth:`PatchLoader.set_position` restarts
that stream where a checkpoint left it.

The host side (pipeline.py:161-249): ``prefetch`` batches are collated ahead
by a daemon thread into a bounded queue, and ``n_workers`` threads fetch the
patches (numpy releases the GIL in the crops and transforms) with a lookahead
of ``batch_size * max(prefetch + 1, 2)``, yielded in order; each patch's
generator is keyed by its position in the epoch, so the batches do not depend
on either setting. ``wire_points='uint16'`` (aligned layouts only) ships the
points quantized to u16, the layout built on the dequantized coordinates so
the cell ids the model recomputes match it. The aligned layout is built by the
C++ host runtime (``native.morton_align``, straight into the batch arrays;
a ctypes call releases the GIL, so the worker threads run it side by side);
``native=False`` takes its numpy plain version, ``host_morton_bucket_aligned``,
bit-equal to it.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from tomosar2height_tpu_torch import native as host_runtime
from tomosar2height_tpu_torch.ops.sorted_scatter import (
    ALIGNED_TILE_CELLS,
    PAD_CELL_SENTINEL,
    PCHUNK,
    aligned_bucket_size,
    dequantize_points_np,
    host_morton_bucket,
    host_morton_bucket_aligned,
    quantize_points_u16,
    trim_aligned_batch,
)

log = logging.getLogger(__name__)


def tile_cells_for_impl(sorted_impl: str) -> int:
    """Aligned-layout Morton tile size the model's kernel path reads: 256
    (16x16) for ``fused``, 1024 (32x32) for ``fused2``."""
    return 256 if sorted_impl == "fused" else ALIGNED_TILE_CELLS


def loader_kwargs(cfg) -> Dict:
    """PatchLoader's bucket, layout, worker and wire arguments from the config
    (train.py:126-151): with ``dataset.points.sort`` the Morton layout that
    ``model.encoder_kwargs.sorted_impl`` reads (aligned with 256-cell tiles
    for ``fused``, 1024 for ``fused2``; the plain sorted layout otherwise),
    ``dataloader.n_workers`` patch-fetching threads and the point wire
    ``dataset.points.wire`` (uint16: aligned layouts only). The prefetch
    depth is :func:`prefetch_depth`: the JAX entry points give it to the
    training and test loaders only."""
    points = cfg["dataset"]["points"]
    enc = cfg["model"]["encoder_kwargs"]
    sort = (bool(points.get("sort", False)) and bool(cfg["use_cloud"])
            and cfg["model"]["encoder"] == "pointnet_local_pool")
    impl = enc.get("sorted_impl", "cumsum")
    return dict(bucket_sizes=points["bucket_sizes"], fixed_bucket=points["train_bucket"],
                sort_reso=enc["plane_resolution"] if sort else None,
                aligned=impl in ("fused", "fused2"), tile_cells=tile_cells_for_impl(impl),
                n_workers=int((cfg.get("dataloader") or {}).get("n_workers", 0) or 0),
                wire_points=str(points.get("wire", "float32")))


def prefetch_depth(cfg) -> int:
    """``dataloader.prefetch`` (default 2, as the JAX entry points read it)."""
    return int((cfg.get("dataloader") or {}).get("prefetch", 2) or 0)


def pick_bucket(n: int, bucket_sizes: Sequence[int]) -> int:
    """Smallest configured bucket that fits n points (caps at the largest)."""
    for b in bucket_sizes:
        if n <= b:
            return int(b)
    return int(bucket_sizes[-1])


def pad_points(pts: np.ndarray, bucket: int, rng: Optional[np.random.Generator] = None):
    """Pad (or uniformly subsample) an (n, 3) array to (bucket, 3) + mask."""
    n = pts.shape[0]
    out = np.zeros((bucket, pts.shape[1]), dtype=np.float32)
    mask = np.zeros((bucket,), dtype=bool)
    if n == 0:
        return out, mask
    if n > bucket:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, bucket, replace=False)
        out[:] = pts[sel]
        mask[:] = True
        return out, mask
    out[:n] = pts
    mask[:n] = True
    return out, mask


class PatchLoader:
    """Iterates batches of padded patches from a :class:`SceneDataset`.

    Yields dicts of numpy arrays: points (B, N, 3) f32 (u16 on the u16 wire),
    point_mask (B, N) bool, patch_valid (B,) bool, min_bound/max_bound (B, 2)
    f64, name list; with ``sort_reso`` also cell (B, N) int32 and
    cell_offsets, (B, T + 1) int32 tile offsets on the aligned layout or
    (B, sort_reso**2 + 1) per-cell offsets on the plain sorted one; dsm
    (B, H, W) f32 when the patches carry targets; image (B, H, W, C) f32 (u8
    on the u8 wire) when they carry image crops, image_origin (B, 2) int32
    on the device-crop wire (zeros on pad entries); with ``det_stream`` also
    ``_stream_pos`` (epoch, next batch). A short last batch is padded with
    invalid patches, so every batch has ``batch_size`` entries. ``native``:
    the aligned layout in the C++ host runtime (the default) or in numpy
    (False: the plain version).
    """

    def __init__(self, dataset, batch_size: int, bucket_sizes: Sequence[int],
                 fixed_bucket: Optional[int] = None, sort_reso: Optional[int] = None,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0,
                 det_stream: bool = False, aligned: bool = True,
                 tile_cells: Optional[int] = None, prefetch: int = 0, n_workers: int = 0,
                 wire_points: str = "float32", native: bool = True):
        self.dataset = dataset
        self.native = bool(native)
        self.batch_size = int(batch_size)
        self.bucket_sizes = sorted(int(b) for b in bucket_sizes)
        self.fixed_bucket = int(fixed_bucket) if fixed_bucket else None
        self.sort_reso = int(sort_reso) if sort_reso else None
        self.aligned = bool(aligned) and self.sort_reso is not None
        self.tile_cells = int(tile_cells or ALIGNED_TILE_CELLS)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.det_stream = bool(det_stream)
        self.prefetch = int(prefetch or 0)
        self.n_workers = int(n_workers or 0)
        if wire_points not in ("float32", "uint16"):
            raise ValueError(f"Invalid wire_points: {wire_points}")
        if wire_points == "uint16" and not self.aligned:
            raise ValueError("wire_points='uint16' requires the aligned layout")
        self.wire_points = wire_points
        self._epoch = 0
        self._start_batch = 0
        self.overflow_patches = 0
        self.overflow_points = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_position(self, epoch: int, batch_idx: int) -> None:
        """Restart the stream at (epoch, batch_idx): the ``_stream_pos`` a
        det_stream batch carries names the position after it, so a
        checkpointed position replays from the next batch; past the epoch's
        last batch it rolls over to the next epoch's first
        (pipeline.py:198-209). Requires ``det_stream``."""
        if not self.det_stream:
            raise ValueError("set_position requires det_stream=True")
        if batch_idx >= len(self):
            epoch, batch_idx = epoch + 1, 0
        self._epoch = int(epoch) - 1  # __iter__ pre-increments it
        self._start_batch = int(batch_idx)

    def _item(self, i: int, epoch: int, pos: int) -> dict:
        """dataset[i]; under det_stream drawn with a generator keyed by
        (seed, epoch, position in the epoch)."""
        if not self.det_stream:
            return self.dataset[i]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, pos]))
        return self.dataset.__getitem__(i, rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        self.overflow_patches = self.overflow_points = 0
        batches = self._batches(self._epoch)
        if self.prefetch <= 0:
            yield from batches
        else:
            yield from _prefetched(batches, self.prefetch)
        if self.overflow_patches:
            log.warning("PatchLoader: %d patches exceeded the largest bucket (%d); "
                        "%d points subsampled away.", self.overflow_patches,
                        self.bucket_sizes[-1], self.overflow_points)

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        # regular-patching loaders are deterministic across re-iterations (the
        # same subsample of over-bucket patches every time); random training
        # loaders resample per epoch (pipeline.py:251-259)
        deterministic = not self.shuffle and not getattr(self.dataset, "random_sample", False)
        rng = np.random.default_rng(self.seed + 1000 + (0 if deterministic else epoch))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        start, self._start_batch = self._start_batch, 0
        batch: List[dict] = []
        bi = start
        for p in self._patches(idx[start * self.batch_size:], epoch, start * self.batch_size):
            batch.append(p)
            if len(batch) == self.batch_size:
                yield self._finish(batch, epoch, bi, rng)
                batch = []
                bi += 1
        if batch:
            yield self._finish(batch, epoch, bi, rng)

    def _patches(self, idx: np.ndarray, epoch: int, base: int) -> Iterator[dict]:
        """dataset[i] for i in ``idx`` in order, ``base`` the epoch position
        of idx[0]; with ``n_workers`` fetched by a thread pool a bounded
        lookahead ahead (pipeline.py:211-249)."""
        if self.n_workers <= 0:
            for k, i in enumerate(idx):
                yield self._item(int(i), epoch, base + k)
            return
        lookahead = self.batch_size * max(self.prefetch + 1, 2)
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            pending = []
            for k, i in enumerate(idx):
                if len(pending) >= lookahead:
                    yield pending.pop(0).result()
                pending.append(pool.submit(self._item, int(i), epoch, base + k))
            for f in pending:
                yield f.result()

    def _finish(self, batch: List[dict], epoch: int, bi: int, rng: np.random.Generator):
        if not self.det_stream:
            return self.collate(batch, rng)
        # position-keyed collate rng (the subsample draws) and the stream
        # position after this batch
        rng = np.random.default_rng(np.random.SeedSequence([self.seed + 1000, epoch, bi]))
        out = self.collate(batch, rng)
        out["_stream_pos"] = (epoch, bi + 1)
        return out

    def _align_native(self, pts: np.ndarray, bucket: int, rng, npad: int, u16: bool, out):
        """One patch's aligned layout by the C++ runtime into its batch rows
        ``out``: the points as ``pad_points`` leaves them (subsampled past the
        bucket with the same draw; the pad rows it would add are masked and
        drop out of the layout), dequantized first on the u16 wire."""
        if len(pts) > bucket:
            pts, _ = pad_points(pts, bucket, rng)
        if u16:
            pts = dequantize_points_np(quantize_points_u16(pts))
            tmp = (np.empty((npad, 3), dtype=np.float32),) + tuple(out[1:])
            a = host_runtime.morton_align(pts, None, self.sort_reso, PCHUNK, self.tile_cells,
                                    npad, int(PAD_CELL_SENTINEL), out=tmp)
            out[0][:] = quantize_points_u16(a["points"])
        else:
            host_runtime.morton_align(pts, None, self.sort_reso, PCHUNK, self.tile_cells, npad,
                                int(PAD_CELL_SENTINEL), out=out)

    def collate(self, patches: List[dict], rng: Optional[np.random.Generator] = None):
        n_real = len(patches)
        if n_real < self.batch_size:
            filler = {"name": "__pad__", "min_bound": np.zeros(2, dtype=np.float64),
                      "max_bound": np.zeros(2, dtype=np.float64), "is_valid": False}
            patches = patches + [filler] * (self.batch_size - n_real)
        bsz = len(patches)
        counts = [len(p["inputs"]) if p["is_valid"] else 0 for p in patches]
        bucket = self.fixed_bucket or pick_bucket(max(max(counts), 1), self.bucket_sizes)
        for cnt in counts:
            if cnt > bucket:
                self.overflow_patches += 1
                self.overflow_points += cnt - bucket
        u16 = self.wire_points == "uint16"
        if self.aligned:
            npad = aligned_bucket_size(bucket, self.sort_reso, tile_cells=self.tile_cells)
            ntiles = (self.sort_reso * self.sort_reso) // self.tile_cells
            points = (np.full((bsz, npad, 3), 32768, dtype=np.uint16) if u16
                      else np.full((bsz, npad, 3), 0.5, dtype=np.float32))
            point_mask = np.zeros((bsz, npad), dtype=bool)
            cells = np.full((bsz, npad), PAD_CELL_SENTINEL, dtype=np.int32)
            offsets = np.zeros((bsz, ntiles + 1), dtype=np.int32)
        else:
            points = np.zeros((bsz, bucket, 3), dtype=np.float32)
            point_mask = np.zeros((bsz, bucket), dtype=bool)
            if self.sort_reso:
                ncell = self.sort_reso * self.sort_reso
                cells = np.full((bsz, bucket), ncell, dtype=np.int32)
                offsets = np.zeros((bsz, ncell + 1), dtype=np.int32)
        patch_valid = np.zeros((bsz,), dtype=bool)
        dsm = image = image_origin = None
        min_bound = np.zeros((bsz, 2), dtype=np.float64)
        max_bound = np.zeros((bsz, 2), dtype=np.float64)
        names = []
        for i, p in enumerate(patches):
            names.append(p["name"])
            min_bound[i] = p["min_bound"][:2]
            max_bound[i] = p["max_bound"][:2]
            if not p["is_valid"]:
                continue
            patch_valid[i] = True
            if self.aligned and self.native:
                self._align_native(p["inputs"], bucket, rng, npad, u16,
                                   (points[i], point_mask[i], cells[i], offsets[i]))
            elif self.aligned:
                pts_i, mask_i = pad_points(p["inputs"], bucket, rng)
                if u16:
                    # the layout on the dequantized coordinates: the cell ids
                    # the model recomputes from the wire then match it
                    pts_i = dequantize_points_np(quantize_points_u16(pts_i))
                a = host_morton_bucket_aligned(pts_i, mask_i, self.sort_reso,
                                               tile_cells=self.tile_cells)
                points[i] = quantize_points_u16(a["points"]) if u16 else a["points"]
                point_mask[i] = a["mask"]
                cells[i], offsets[i] = a["cells"], a["tile_offsets"]
            elif self.sort_reso:
                pts_i, mask_i = pad_points(p["inputs"], bucket, rng)
                order, cells[i], offsets[i] = host_morton_bucket(pts_i, mask_i,
                                                                 self.sort_reso)
                points[i], point_mask[i] = pts_i[order], mask_i[order]
            else:
                points[i], point_mask[i] = pad_points(p["inputs"], bucket, rng)
            if "dsm" in p:
                if dsm is None:
                    dsm = np.zeros((bsz,) + p["dsm"].shape, dtype=np.float32)
                dsm[i] = p["dsm"]
            if "image" in p:
                if image is None:  # u8 on the u8 wire, f32 otherwise
                    image = np.zeros((bsz,) + p["image"].shape, dtype=p["image"].dtype)
                image[i] = p["image"]
            if "image_origin" in p:
                if image_origin is None:  # pad entries keep (0, 0), in the image
                    image_origin = np.zeros((bsz, 2), dtype=np.int32)
                image_origin[i] = p["image_origin"]

        out = {"patch_valid": patch_valid, "min_bound": min_bound,
               "max_bound": max_bound, "name": names}
        if dsm is not None:
            out["dsm"] = dsm
        if image is not None:
            out["image"] = image
        if image_origin is not None:
            out["image_origin"] = image_origin
        if self.aligned:
            points, point_mask, cells, offsets = trim_aligned_batch(
                points, point_mask, cells, offsets)
        if self.sort_reso:
            out["cell"], out["cell_offsets"] = cells, offsets
        out["points"], out["point_mask"] = points, point_mask
        return out


_DONE = object()


def _prefetched(batches: Iterator, depth: int) -> Iterator:
    """``batches`` produced by a daemon thread ``depth`` batches ahead of the
    consumer (pipeline.py:161-187). An exception in the producer is raised in
    the consumer; a consumer that stops early stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for b in batches:
                if not put(b):
                    return
            put(_DONE)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            batches.close()  # a stopped epoch shuts its worker pool down here

    worker = threading.Thread(target=produce, name="PatchLoader-prefetch", daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        worker.join(timeout=60)
