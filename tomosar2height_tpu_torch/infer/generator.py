"""Sliding-window full-scene nDSM generation with linear-blend stitching.

Counterpart of ``tomosar2height_tpu/infer/generator.py`` on one GPU
(reference generator.py:15-165): scene raster from the union of chunk bounds,
batched model forward, row un-flip to north-up, linear-ramp blend weights
(min 1e-3), final divide + clamp >= 0 (NaN where no patch reached), GeoTIFF
write. Pixel origins and the written file are bit-identical to the JAX
package's.

Two blends, as in the JAX generator:

- the host blend (the default): the tile rasters come down to the host and
  are accumulated in float64 by the C++ host runtime
  (``native.blend_accumulate_batch``: threads over disjoint row bands, each
  pixel's adds in batch order, windows clipped to the scene; it releases the
  GIL), or by its numpy plain version (``native=False``), bit-equal to it.
  The forward of batch k runs on the card while the host blends batch k-1:
  the rasters come back through a pinned buffer with an event, so the only
  waits are on results the host needs.
- ``device_blend=True`` (generator.py:147, :160-220, :377-582): float32 scene
  rasters on the model's device; each tile, in batch order, adds
  ``h * pw32 * v`` into its window and ``pw32 * v`` into the weight window
  (``pw32`` the float64 weight cast once, ``v`` 1 for a valid entry, 0 for a
  pad), the window's origin clamped into the raster as
  ``lax.dynamic_update_slice`` clamps it (the host blend clips instead);
  slice adds in a fixed order, no atomics, so the raster is bit-equal run to
  run. The scene splits into bands a tile high; each band is finalized on the
  device (``where(w > 0, max(d / w, 0), nan)`` in the wire's dtype) once its
  last batch has blended, and comes down through a pinned buffer on a side
  stream while the remaining batches run; a scene of one band is fetched
  once at the end. ``blend_loop`` ('unroll' or 'scan') is checked as the JAX
  generator checks it and has no effect here: in eager PyTorch both run the
  one loop of slice adds, so they give the same bits.

With ``use_image`` each batch's image crops upload beside the points:
normalized f32 crops, or raw u8 crops that the card normalizes with the
dataset's ``image_norm`` (the u8 wire, generator.py:102-104, :280-284); on
the device-crop wire the scene image uploads once and each tile's crop is
sliced from it on the card and flipped y-up (generator.py:105-112,
:265-279). ``wire_dtype='float16'``: on the host blend each tile raster comes
down in f16 (the JAX generator rounds only on its device blend); on the
device blend the finalized raster is rounded, as in JAX. ``wire_cells='host'``
uploads the aligned layouts' cell ids instead of the model recomputing them
(generator.py:154-159, :307). Multi-GPU meshes are not ported yet (ROADMAP:
data parallelism).
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from tomosar2height_tpu_torch import native as host_runtime
from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset
from tomosar2height_tpu_torch.data.pipeline import loader_kwargs, prefetch_depth
from tomosar2height_tpu_torch.geo import RasterData
from tomosar2height_tpu_torch.geo.raster import cal_dsm_shape
from tomosar2height_tpu_torch.native import plain

log = logging.getLogger(__name__)


def linear_blend_weight(grid_shape_2d, half_blend_percent) -> np.ndarray:
    """Separable linear ramp weights for overlap blending
    (reference generator.py:85-113; MIN_WEIGHT 1e-3, float64)."""
    assert 0 <= half_blend_percent[0] <= 0.5, "Blend percent X should be between 0 and 0.5."
    assert 0 <= half_blend_percent[1] <= 0.5, "Blend percent Y should be between 0 and 0.5."
    MIN_WEIGHT = 1e-3
    wx = np.ones(grid_shape_2d, dtype=np.float64)
    wy = np.ones(grid_shape_2d, dtype=np.float64)
    idx_x = math.floor(grid_shape_2d[0] * half_blend_percent[0])
    idx_y = math.floor(grid_shape_2d[1] * half_blend_percent[1])
    if idx_x > 0:
        ramp = np.linspace(MIN_WEIGHT, 1, idx_x)
        wx[:, :idx_x] = ramp[None, :]
        wx[:, -idx_x:] = ramp[::-1][None, :]
    if idx_y > 0:
        ramp = np.linspace(MIN_WEIGHT, 1, idx_y)
        wy[:idx_y, :] = ramp[:, None]
        wy[-idx_y:, :] = ramp[::-1][:, None]
    return wx * wy


class DSMGenerator:
    """Full-scene nDSM generator over a sliding-window PatchLoader."""

    def __init__(self, model: torch.nn.Module, data_loader, dsm_pixel_size,
                 half_blend_percent=None, crs_epsg: Optional[int] = 25832,
                 use_image: bool = False, wire_dtype: str = "float32",
                 wire_cells: str = "device", native: bool = True,
                 device_blend: bool = False, blend_loop: str = "unroll"):
        """
        Args:
            model: the port's ``TomoSAR2Height``, on its device.
            data_loader: PatchLoader over a regular-patching dataset (with
                image crops, or their origins on the device-crop wire, when
                ``use_image``).
            wire_dtype: 'float32' or 'float16': the tile rasters' download on
                the host blend, the finalized raster's on the device blend.
            wire_cells: 'device' (the model recomputes the aligned layouts'
                cell ids) or 'host' (they upload).
            native: the host blend in the C++ runtime (the default) or in
                numpy (False: the plain version).
            device_blend: blend on the model's device in float32.
            blend_loop: 'unroll' or 'scan', the JAX generator's argument;
                both run the same loop here.
        """
        self.model = model
        self.use_image = bool(use_image)
        self.device = next(model.parameters()).device
        self.data_loader = data_loader
        self.wire_dtype = np.dtype(wire_dtype)
        if self.wire_dtype not in (np.float32, np.float16):
            raise ValueError(f"Invalid wire_dtype: {wire_dtype}")
        if wire_cells not in ("device", "host"):
            raise ValueError(f"Invalid wire_cells: {wire_cells}")
        self.wire_cells = wire_cells
        if blend_loop not in ("unroll", "scan"):
            raise ValueError(f"Invalid blend_loop: {blend_loop}")
        self.native = bool(native)
        self.device_blend = bool(device_blend)
        self.blend_loop = blend_loop
        self._side_stream = None
        dataset = data_loader.dataset
        norm = getattr(dataset, "image_norm", None) if self.use_image else None
        self._image_norm = None if norm is None else tuple(
            torch.as_tensor(x, device=self.device) for x in norm)
        self._device_image = self.use_image and getattr(dataset, "image_crop_device", False)
        self._scene_dev = None
        self.pixel_size = np.asarray(dsm_pixel_size, dtype=np.float64)
        self.half_blend_percent = list(half_blend_percent or [0.5, 0.5])
        self.crs_epsg = crs_epsg
        assert not dataset.random_sample, "Only regular patching is accepted."
        self.patch_size = np.asarray(dataset.patch_size, dtype=np.float64)
        self._calculate_bounds(dataset.chunk_info_ls)
        self.dsm_shape = cal_dsm_shape(
            [self.l_bound, self.b_bound], [self.r_bound, self.t_bound], self.pixel_size)
        grid_shape = np.round(self.patch_size / self.pixel_size).astype(int)
        self.patch_weight = linear_blend_weight(
            (int(grid_shape[0]), int(grid_shape[1])), self.half_blend_percent)
        self.last_stats = None

    def _calculate_bounds(self, chunk_info_ls):
        """Scene bbox = union of chunk bounds (reference generator.py:61-72)."""
        self.l_bound = self.b_bound = np.inf
        self.r_bound = self.t_bound = -np.inf
        for info in chunk_info_ls:
            l, b = info["min_bound"][:2]
            r, t = info["max_bound"][:2]
            self.l_bound = min(self.l_bound, l)
            self.b_bound = min(self.b_bound, b)
            self.r_bound = max(self.r_bound, r)
            self.t_bound = max(self.t_bound, t)

    def _heights(self, points, mask, image, cells, offsets) -> torch.Tensor:
        """The tile rasters (B, ph, pw) float32, north-up."""
        if image is not None and self._image_norm is not None:
            mean, std = self._image_norm
            image = (image.to(torch.float32) - mean) / std
        pa, _ = self.model(points, mask, image, cells, offsets, footprint=False)
        # un-flip rows: the model works y-up, the raster is north-up
        return pa[..., 0].flip(1)

    def _forward_impl(self, points, mask, image, cells, offsets) -> torch.Tensor:
        """The tile rasters in the wire's dtype: the host blend's download."""
        h = self._heights(points, mask, image, cells, offsets)
        return h.to(torch.float16) if self.wire_dtype == np.float16 else h

    def _scene_image(self) -> torch.Tensor:
        """The device-crop wire's scene image (H, W, C), uploaded once."""
        if self._scene_dev is None:
            scene = self.data_loader.dataset.scene_image_hwc()
            self._scene_dev = torch.from_numpy(scene).to(self.device)
        return self._scene_dev

    def _device_crops(self, origins: np.ndarray) -> torch.Tensor:
        """(B, h, w, C) crops sliced from the resident scene image at the
        (B, 2) host origins, rows flipped y-up: the host crop's bytes."""
        h, w = (int(v) for v in self.data_loader.dataset._image_patch_shape)
        scene = self._scene_image()
        return torch.stack([scene[r:r + h, c:c + w] for r, c in origins.tolist()]).flip(1)

    def _dispatch(self, batch, forward=None) -> torch.Tensor:
        """Upload one batch and issue its forward (asynchronous on a card).
        On ``wire_cells='device'`` the aligned layouts' cell ids are not
        uploaded: the model recomputes them from points + mask, bit-exact (the
        JAX default); the plain sorted layout ships them either way.
        ``forward`` (default :meth:`_forward_impl`) takes the uploads."""
        def up(key):
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if self.device.type == "cuda":  # pinned: the copy overlaps the host
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        offsets = up("cell_offsets") if "cell_offsets" in batch else None
        ship_cells = not self.data_loader.aligned or self.wire_cells == "host"
        cells = up("cell") if offsets is not None and ship_cells else None
        image = None
        if self._device_image:
            image = self._device_crops(batch["image_origin"])
        elif self.use_image:
            image = up("image")
        forward = forward or self._forward_impl
        return forward(up("points"), up("point_mask"), image, cells, offsets)

    def _fetch(self, h_dev: torch.Tensor):
        """Start the device -> host copy; returns (host tensor, ready event)."""
        if h_dev.device.type != "cuda":
            return h_dev, None
        h_host = torch.empty(h_dev.shape, dtype=h_dev.dtype, pin_memory=True)
        h_host.copy_(h_dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return h_host, ev

    def _patch_origins(self, tiff_data, batch):
        """Host-side f64 geo math: scene raster (row, col) origin per patch."""
        b = len(batch["patch_valid"])
        valid = np.asarray(batch["patch_valid"], dtype=bool)
        rows0 = np.zeros(b, dtype=np.int64)
        cols0 = np.zeros(b, dtype=np.int64)
        for i in range(b):
            if not valid[i]:
                continue
            min_c = batch["min_bound"][i] + self.pixel_size / 2.0
            l_col, _ = tiff_data.query_col_row(min_c[0], min_c[1])
            max_c = batch["max_bound"][i] - self.pixel_size / 2.0
            _, t_row = tiff_data.query_col_row(max_c[0], max_c[1])
            rows0[i], cols0[i] = t_row, l_col
        return rows0, cols0, valid

    def _blend_batch(self, tiff_data, dsm_acc, weight_acc, h_grids, batch) -> int:
        """Blend-accumulate one batch of patch rasters on the host in float64
        (the C++ runtime's banded batch blend, or its numpy plain version).
        Returns the number of valid patches blended."""
        rows0, cols0, valid = self._patch_origins(tiff_data, batch)
        blend = (host_runtime.blend_accumulate_batch if self.native
                 else plain.blend_accumulate_batch)
        blend(dsm_acc, weight_acc, np.asarray(h_grids, dtype=np.float64), self.patch_weight,
              rows0, cols0, valid)
        return int(valid.sum())

    # --- the device blend (generator.py:147, :160-220, :377-582) ------------

    def _blend_step(self, dsm: torch.Tensor, wgt: torch.Tensor, h: torch.Tensor,
                    pw32: torch.Tensor, rows0, cols0, valid) -> None:
        """Add one batch of tile rasters into the scene rasters in place, in
        batch order (``_blend_step_impl``): each entry's window, its origin
        clamped into the raster, gains ``h * pw32 * v`` and its weight window
        ``pw32 * v``."""
        ph, pwid = pw32.shape
        hh, ww = dsm.shape
        rmax, cmax = max(hh - ph, 0), max(ww - pwid, 0)
        for i in range(h.shape[0]):
            r = min(max(int(rows0[i]), 0), rmax)
            c = min(max(int(cols0[i]), 0), cmax)
            v = float(valid[i])
            dsm[r:r + ph, c:c + pwid] += h[i].float() * pw32 * v
            wgt[r:r + ph, c:c + pwid] += pw32 * v

    def _band_plan(self, tiff_data):
        """([(r0, r1)], last-touch batch index of each band) for the early
        band fetch (generator.py:377-422), or None where the scene is one
        band or the loader's patches are not known ahead. Bands are a tile
        high; a band's last batch is the last whose clamped window reaches
        it."""
        ds = self.data_loader.dataset
        anchors = getattr(ds, "anchor_points", None)
        if not anchors or getattr(ds, "random_sample", True):
            return None
        bsz, nb = self.data_loader.batch_size, len(self.data_loader)
        ph = int(self.patch_weight.shape[0])
        hh = int(self.dsm_shape[0])
        nbands = max(1, -(-hh // ph))
        if nbands < 2:
            return None
        last = np.full(nbands, -1, dtype=np.int64)
        for j, a in enumerate(anchors):
            k = j // bsz
            if k >= nb:
                break
            max_c = (np.asarray(a["anchor"], np.float64)[:2] + self.patch_size[:2]
                     - self.pixel_size[:2] / 2.0)
            _, t_row = tiff_data.query_col_row(max_c[0], max_c[1])
            r_eff = min(max(int(t_row), 0), max(hh - ph, 0))  # the blend's clamp
            b0, b1 = r_eff // ph, min(r_eff + ph - 1, hh - 1) // ph
            for b in range(b0, min(b1, nbands - 1) + 1):
                last[b] = max(last[b], k)
        last[last < 0] = 0  # untouched bands: all NaN, fetched at once
        return [(b * ph, min((b + 1) * ph, hh)) for b in range(nbands)], last

    def _finalize(self, d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``where(w > 0, max(d / w, 0), nan)`` in the wire's dtype."""
        out = torch.where(w > 0, torch.clamp_min(d / w, 0.0), torch.full_like(d, math.nan))
        return out.to(torch.float16 if self.wire_dtype == np.float16 else torch.float32)

    def _fetch_band(self, band: torch.Tensor):
        """Start a finalized band's download on a side stream, behind the
        work queued so far: (host tensor, ready event)."""
        if band.device.type != "cuda":
            return band, None
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(band.device)
        side = self._side_stream
        side.wait_stream(torch.cuda.current_stream(band.device))
        with torch.cuda.stream(side):
            host = torch.empty(band.shape, dtype=band.dtype, pin_memory=True)
            host.copy_(band, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        band.record_stream(side)
        return host, ev

    def _generate_device_blend(self, tiff_data, save_to: str) -> RasterData:
        start = time.perf_counter()
        hh, ww = (int(v) for v in self.dsm_shape)
        dsm = torch.zeros((hh, ww), dtype=torch.float32, device=self.device)
        wgt = torch.zeros_like(dsm)
        pw32 = torch.from_numpy(self.patch_weight.astype(np.float32)).to(self.device)
        plan = self._band_plan(tiff_data)
        fetched = {}
        n_patches, t_loader, t_dispatch = 0, 0.0, 0.0
        it = iter(self.data_loader)
        k = 0
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            t_loader += time.perf_counter() - t0
            if batch is None:
                break
            t0 = time.perf_counter()
            rows0, cols0, valid = self._patch_origins(tiff_data, batch)
            n_patches += int(valid.sum())
            if valid.any():  # an all-pad batch adds nothing
                h = self._dispatch(batch, self._heights)
                if tuple(h.shape[1:]) != tuple(pw32.shape):
                    raise ValueError(f"tile rasters {tuple(h.shape[1:])} against the blend "
                                     f"weight {tuple(pw32.shape)}")
                self._blend_step(dsm, wgt, h, pw32, rows0, cols0, valid)
            if plan is not None:  # bands whose last batch just blended
                bands, last = plan
                for b in np.nonzero(last == k)[0]:
                    r0, r1 = bands[b]
                    fetched[int(b)] = self._fetch_band(self._finalize(dsm[r0:r1], wgt[r0:r1]))
            k += 1
            t_dispatch += time.perf_counter() - t0
        out = np.empty((hh, ww), dtype=self.wire_dtype)
        if plan is not None:
            bands, _ = plan
            t0 = time.perf_counter()
            for b, (r0, r1) in enumerate(bands):
                if b not in fetched:  # the loader gave fewer batches than planned
                    fetched[b] = self._fetch_band(self._finalize(dsm[r0:r1], wgt[r0:r1]))
            for b, (host, ev) in fetched.items():
                if ev is not None:
                    ev.synchronize()
                r0, r1 = bands[b]
                out[r0:r1] = host.numpy()
            t_drain, t_fetch = 0.0, time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_drain = time.perf_counter() - t0
            t0 = time.perf_counter()
            out[:] = self._finalize(dsm, wgt).cpu().numpy()
            t_fetch = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiff_data.data = np.maximum(out.astype(np.float32), 0.0)
        tiff_data.write_to_file(save_to)
        t_finalize = time.perf_counter() - t0
        total = time.perf_counter() - start
        self.last_stats = {
            "total_s": total, "n_patches": n_patches, "loader_s": t_loader,
            "dispatch_s": t_dispatch, "device_wait_blend_s": t_drain + t_fetch,
            "drain_s": t_drain, "fetch_wait_s": t_fetch, "blend_cpu_s": 0.0,
            "fetch_thread_s": t_fetch, "finalize_write_s": t_finalize,
            "patches_per_s": n_patches / total if total > 0 else 0.0,
        }
        log.info("DSM generation (device blend): %.2f s, %d patches, %.2f tiles/s (loader "
                 "%.2f | dispatch %.2f | drain %.2f | fetch %.2f | write %.2f)", total,
                 n_patches, self.last_stats["patches_per_s"], t_loader, t_dispatch, t_drain,
                 t_fetch, t_finalize)
        return tiff_data

    @torch.inference_mode()
    def generate_dsm(self, save_to: str) -> RasterData:
        """Generate the scene's nDSM, write it to ``save_to`` as a GeoTIFF and
        return it (``.data`` (rows, cols) f32 in meters, NaN where no patch
        reached; ``.transform``)."""
        tiff_data = RasterData([self.l_bound, self.b_bound], [self.r_bound, self.t_bound],
                               self.pixel_size, self.crs_epsg)
        if self.device_blend:
            return self._generate_device_blend(tiff_data, save_to)
        dsm_acc = np.zeros(self.dsm_shape, dtype=np.float64)
        weight_acc = np.zeros(self.dsm_shape, dtype=np.float64)
        start = time.perf_counter()
        n_patches = 0
        t_loader = t_dispatch = t_wait = t_blend = 0.0
        pending: deque = deque()

        def blend_one():
            nonlocal n_patches, t_wait, t_blend
            h_host, ev, b = pending.popleft()
            t0 = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            t_wait += time.perf_counter() - t0
            t0 = time.perf_counter()
            n_patches += self._blend_batch(tiff_data, dsm_acc, weight_acc,
                                           h_host.numpy(), b)
            t_blend += time.perf_counter() - t0

        it = iter(self.data_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            t_loader += time.perf_counter() - t0
            if batch is None:
                break
            t0 = time.perf_counter()
            pending.append(self._fetch(self._dispatch(batch)) + (batch,))
            t_dispatch += time.perf_counter() - t0
            if len(pending) > 1:  # blend k-1 while the card runs k
                blend_one()
        while pending:
            blend_one()

        t0 = time.perf_counter()
        with np.errstate(invalid="ignore", divide="ignore"):
            out = dsm_acc / weight_acc
        out = np.maximum(out, 0.0)
        tiff_data.data = out.astype(np.float32)
        tiff_data.write_to_file(save_to)
        t_finalize = time.perf_counter() - t0
        total = time.perf_counter() - start
        self.last_stats = {
            "total_s": total, "n_patches": n_patches, "loader_s": t_loader,
            "dispatch_s": t_dispatch, "fetch_wait_s": t_wait, "blend_cpu_s": t_blend,
            "finalize_write_s": t_finalize,
            "patches_per_s": n_patches / total if total > 0 else 0.0,
        }
        log.info("DSM generation: %.2f s, %d patches, %.2f tiles/s (loader %.2f | "
                 "dispatch %.2f | wait %.2f | blend %.2f | write %.2f)", total,
                 n_patches, self.last_stats["patches_per_s"], t_loader, t_dispatch,
                 t_wait, t_blend, t_finalize)
        return tiff_data


def make_generator(model: torch.nn.Module, cfg, chunks, image=None,
                   wire_dtype: str = "float32", wire_cells: str = "device",
                   device_blend: bool = False, blend_loop: str = "unroll",
                   native: bool = True) -> DSMGenerator:
    """The serving stack of the JAX package's ``test.py`` over in-memory
    chunks (and, when ``cfg['use_image']``, the scene's satellite ``image``
    as ``(data (C, H, W), raster)``, on the config's image wire and crop):
    dataset -> loader -> generator. With ``dataset.points.sort`` the loader
    ships the layout that ``model.encoder_kwargs.sorted_impl`` reads
    (test.py:53-63): aligned with 256-cell tiles for ``fused``, 1024 for
    ``fused2``, the plain sorted layout for ``pallas``/``cumsum``; its
    prefetch thread and worker pool are ``dataloader.prefetch`` and
    ``dataloader.n_workers``, its point wire ``dataset.points.wire``
    (:func:`~tomosar2height_tpu_torch.data.pipeline.loader_kwargs`,
    :func:`~tomosar2height_tpu_torch.data.pipeline.prefetch_depth`).
    ``wire_dtype``, ``wire_cells``, ``device_blend`` and ``blend_loop`` go to
    the generator; ``native`` to the dataset, the loader and the generator
    (False: the host runtime's numpy plain versions)."""
    use_image = bool(cfg["use_image"])
    if use_image and image is None:
        raise ValueError("use_image: pass the scene's satellite image")
    loader = PatchLoader(
        SceneDataset(chunks, cfg["dataset"], "test", image=image if use_image else None,
                     native=native),
        cfg["training"]["val_batch_size"], prefetch=prefetch_depth(cfg), native=native,
        **loader_kwargs(cfg))
    dsm = cfg["dsm_generation"]
    return DSMGenerator(model, loader, dsm["pixel_size"],
                        half_blend_percent=dsm.get("half_blend_percent"),
                        crs_epsg=dsm.get("crs_epsg"), use_image=use_image,
                        wire_dtype=wire_dtype, wire_cells=wire_cells, native=native,
                        device_blend=device_blend, blend_loop=blend_loop)
