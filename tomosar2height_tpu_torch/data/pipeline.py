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
identical batches for one dataset. Prefetch threads, worker pools, the u16
point wire and ``set_position`` (resume, with checkpoints) are not ported yet
(ROADMAP: checkpoints; wires and the host side).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from tomosar2height_tpu_torch.ops.sorted_scatter import (
    ALIGNED_TILE_CELLS,
    PAD_CELL_SENTINEL,
    aligned_bucket_size,
    host_morton_bucket,
    host_morton_bucket_aligned,
    trim_aligned_batch,
)

log = logging.getLogger(__name__)


def tile_cells_for_impl(sorted_impl: str) -> int:
    """Aligned-layout Morton tile size the model's kernel path reads: 256
    (16x16) for ``fused``, 1024 (32x32) for ``fused2``."""
    return 256 if sorted_impl == "fused" else ALIGNED_TILE_CELLS


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

    Yields dicts of numpy arrays: points (B, N, 3) f32, point_mask (B, N)
    bool, patch_valid (B,) bool, min_bound/max_bound (B, 2) f64, name list;
    with ``sort_reso`` also cell (B, N) int32 and cell_offsets, (B, T + 1)
    int32 tile offsets on the aligned layout or (B, sort_reso**2 + 1) per-cell
    offsets on the plain sorted one; dsm (B, H, W) f32 when the patches carry
    targets; image (B, H, W, C) f32 when they carry image crops (zeros on pad
    entries); with ``det_stream`` also ``_stream_pos`` (epoch, next batch). A
    short last batch is padded with invalid patches, so every batch has
    ``batch_size`` entries.
    """

    def __init__(self, dataset, batch_size: int, bucket_sizes: Sequence[int],
                 fixed_bucket: Optional[int] = None, sort_reso: Optional[int] = None,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0,
                 det_stream: bool = False, aligned: bool = True,
                 tile_cells: Optional[int] = None):
        self.dataset = dataset
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
        self._epoch = 0
        self.overflow_patches = 0
        self.overflow_points = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _item(self, i: int, pos: int) -> dict:
        """dataset[i]; under det_stream drawn with a generator keyed by
        (seed, epoch, position in the epoch)."""
        if not self.det_stream:
            return self.dataset[i]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch, pos]))
        return self.dataset.__getitem__(i, rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        self.overflow_patches = self.overflow_points = 0
        # regular-patching loaders are deterministic across re-iterations (the
        # same subsample of over-bucket patches every time); random training
        # loaders resample per epoch (pipeline.py:251-259)
        deterministic = not self.shuffle and not getattr(self.dataset, "random_sample", False)
        rng = np.random.default_rng(self.seed + 1000 + (0 if deterministic else self._epoch))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        batch: List[dict] = []
        bi = 0
        for pos, i in enumerate(idx):
            batch.append(self._item(int(i), pos))
            if len(batch) == self.batch_size:
                yield self._finish(batch, bi, rng)
                batch = []
                bi += 1
        if batch:
            yield self._finish(batch, bi, rng)
        if self.overflow_patches:
            log.warning("PatchLoader: %d patches exceeded the largest bucket (%d); "
                        "%d points subsampled away.", self.overflow_patches,
                        self.bucket_sizes[-1], self.overflow_points)

    def _finish(self, batch: List[dict], bi: int, rng: np.random.Generator):
        if not self.det_stream:
            return self.collate(batch, rng)
        # position-keyed collate rng (the subsample draws) and the stream
        # position after this batch
        rng = np.random.default_rng(np.random.SeedSequence([self.seed + 1000, self._epoch, bi]))
        out = self.collate(batch, rng)
        out["_stream_pos"] = (self._epoch, bi + 1)
        return out

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

        if self.aligned:
            npad = aligned_bucket_size(bucket, self.sort_reso, tile_cells=self.tile_cells)
            ntiles = (self.sort_reso * self.sort_reso) // self.tile_cells
            points = np.full((bsz, npad, 3), 0.5, dtype=np.float32)
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
        dsm = image = None
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
            pts_i, mask_i = pad_points(p["inputs"], bucket, rng)
            if self.aligned:
                a = host_morton_bucket_aligned(pts_i, mask_i, self.sort_reso,
                                               tile_cells=self.tile_cells)
                points[i], point_mask[i] = a["points"], a["mask"]
                cells[i], offsets[i] = a["cells"], a["tile_offsets"]
            elif self.sort_reso:
                order, cells[i], offsets[i] = host_morton_bucket(pts_i, mask_i,
                                                                 self.sort_reso)
                points[i], point_mask[i] = pts_i[order], mask_i[order]
            else:
                points[i], point_mask[i] = pts_i, mask_i
            if "dsm" in p:
                if dsm is None:
                    dsm = np.zeros((bsz,) + p["dsm"].shape, dtype=np.float32)
                dsm[i] = p["dsm"]
            if "image" in p:
                if image is None:
                    image = np.zeros((bsz,) + p["image"].shape, dtype=np.float32)
                image[i] = p["image"]

        out = {"patch_valid": patch_valid, "min_bound": min_bound,
               "max_bound": max_bound, "name": names}
        if dsm is not None:
            out["dsm"] = dsm
        if image is not None:
            out["image"] = image
        if self.aligned:
            points, point_mask, cells, offsets = trim_aligned_batch(
                points, point_mask, cells, offsets)
        if self.sort_reso:
            out["cell"], out["cell_offsets"] = cells, offsets
        out["points"], out["point_mask"] = points, point_mask
        return out
