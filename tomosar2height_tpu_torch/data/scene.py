"""Patches of a scene held in memory, for serving and training.

The patch math of ``tomosar2height_tpu/data/dataset.py:TomoSARDataset``:
sliding-window anchors (serving, validation) or random anchors (training,
dataset.py:252-261), the same float64 world -> unit-square normalization
with a per-patch z shift (``local_min``, the patch's lowest point, or
``global_min``, the lower z bound; dataset.py:244-301), the flip/rotate
augmentation drawn from the item's generator after the z shift (a quarter
turn count, then a flip axis; dataset.py:288-298) and composed into the
normalization as ``shift_norm @ flip @ rot @ inv(transform)``, the same crop
index, with a GT nDSM raster the target crop, augmented as the points and
flipped to y-up (dataset.py:337-360), and with a satellite image its crop,
augmented, y-up and HWC: normalized f32 (the f32 wire) or the raw u8 pixels
with ``image_norm`` = (mean, std) for the device to apply (the u8 wire,
dataset.py:93-123); or, on the device-crop wire (serving loaders only: no
random anchors, augmentation or target), no crop but the crop's pixel
origin ``image_origin`` in the scene image (:meth:`scene_image_hwc`,
dataset.py:125-136, :318-327). The patch's world crop (the grid index's
exact filter) and its normalize (transform, float32 cast, recrop) run in the
port's C++ host runtime (``native.crop_pc_2d_index``,
``native.crop_transform_patch``), which releases the GIL; ``native=False``
takes their numpy plain versions, bit-equal to it. Both sum the transform
elementwise (``geo.transform_points``), where the JAX dataset's numpy path
takes a BLAS product and its C++ path (patches of >= 4096 points) fused
multiply-adds: each within an ulp of float64 of the other, the same float32
point but where an ulp crosses a rounding edge. Chunks come in as arrays and
rasters; :class:`~tomosar2height_tpu_torch.data.dataset.TomoSARDataset`
reads them from a built dataset on disk and hands them here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from tomosar2height_tpu_torch import native as host_runtime
from tomosar2height_tpu_torch.geo import (
    FLIP_MATRICES,
    ROT_MATRICES,
    GridIndex2D,
    invert_transform,
)
from tomosar2height_tpu_torch.native import plain


class SceneDataset:
    """Patch dataset over in-memory chunks.

    Args:
        chunks: one dict per chunk with ``name``, ``min_bound``/``max_bound``
            (world xy[, z]) and ``points`` (n, 3) float64 world coordinates.
        cfg_dataset: the ``dataset`` config node (patch_size,
            sliding_window.<split>_strip, normalize.{x_range, y_range,
            z_bound, z_shift}).
        split: which sliding-window stride to use (regular patching).
        random_sample: random anchors instead of the sliding window; chunk
            ``idx % len(chunks)``, one ``rng.random(2)`` draw per patch.
        random_length: the dataset's length when ``random_sample``.
        dsm: the GT nDSM as ``(data (H, W) f32, raster)`` with ``raster`` a
            :class:`~tomosar2height_tpu_torch.geo.RasterData` of its grid; each
            valid patch then carries its target crop ``dsm`` (h, w), y-up.
        image: the satellite image as ``(data (C, H, W), raster)`` with
            ``cfg_dataset['satellite_image']``'s ``normalize`` (mean, std per
            channel), ``wire`` and ``crop``: on the 'float32' wire (the
            default) the raw values are normalized once here (in float64,
            kept as f32) and each valid patch carries its crop ``image``
            (h, w, C) f32, y-up; on the 'uint8' wire the raw values must be
            integral in [0, 255] and ship as u8 crops, ``image_norm`` holding
            the f32 (mean, std) that the trainer and generator apply on the
            card; ``crop='device'`` (serving loaders only) replaces the crop
            by ``image_origin`` (row0, col0). Random anchors snap to the
            image's pixel grid.
        flip_augm, rotate_augm: the augmentation: a flip axis (-1 none, 0
            x, 1 y) and a count of clockwise quarter turns drawn per patch
            from its generator, applied to the points, the image and the
            target alike; each valid patch carries ``flip``, ``rotate`` and
            ``transform`` (the inverse normalization).
        native: the crops and the normalize in the C++ host runtime (the
            default), or in numpy (False: the plain version).
    """

    def __init__(self, chunks: Sequence[Dict], cfg_dataset: Dict, split: str = "test",
                 random_sample: bool = False, random_length: Optional[int] = None,
                 dsm=None, image=None, flip_augm: bool = False, rotate_augm: bool = False,
                 native: bool = True):
        self.native = bool(native)
        self.flip_augm, self.rotate_augm = bool(flip_augm), bool(rotate_augm)
        self.patch_size = np.asarray(cfg_dataset["patch_size"], dtype=np.float64)
        norm = cfg_dataset["normalize"]
        self.z_shift = norm.get("z_shift", "local_min")
        if self.z_shift not in ("local_min", "global_min"):
            raise ValueError(f"Unknown shift strategy: {self.z_shift}")
        self.random_sample = bool(random_sample)
        self.random_length = int(random_length) if random_length is not None else 10
        self.dsm_data, self.dsm = (None, None) if dsm is None else dsm
        if self.dsm is not None:
            a, _, _, _, e, _ = self.dsm.transform
            shape = self.patch_size / np.array([a, -e])
            if not np.all(np.floor(shape) == shape):
                raise ValueError("patch size must be a multiple of the DSM pixel size")
            self._dsm_pixel_size = np.array([a, -e], dtype=np.float64)
            self._dsm_patch_shape = shape.astype(np.int64)
        self.image_data, self.image = (None, None) if image is None else image
        self.image_norm = None
        self.image_crop_device = False
        if self.image is not None:
            img_cfg = cfg_dataset["satellite_image"]
            mean = np.asarray(img_cfg["normalize"]["mean"], dtype=np.float64)
            std = np.asarray(img_cfg["normalize"]["std"], dtype=np.float64)
            stack = np.asarray(self.image_data, dtype=np.float64)
            wire = str(img_cfg.get("wire", "float32"))
            if wire == "uint8":
                if not (stack.min() >= 0 and stack.max() <= 255
                        and np.allclose(stack, np.round(stack), atol=1e-3)):
                    raise ValueError("satellite_image.wire=uint8 needs integral u8-range "
                                     "source imagery; this source is not (use float32)")
                self.image_data = np.round(stack).astype(np.uint8)
                self.image_norm = (mean.astype(np.float32), std.astype(np.float32))
            elif wire == "float32":
                self.image_data = ((stack - mean[:, None, None])
                                   / std[:, None, None]).astype(np.float32)
            else:
                raise ValueError(f"Invalid satellite_image.wire: {wire}")
            crop = str(img_cfg.get("crop", "host"))
            if crop not in ("host", "device"):
                raise ValueError(f"Invalid satellite_image.crop: {crop}")
            # the device crop serves the generator's loaders only; training
            # and validation loaders keep host crops (dataset.py:125-136)
            self.image_crop_device = (crop == "device" and not self.random_sample
                                      and not self.flip_augm and not self.rotate_augm
                                      and self.dsm is None)
            self._scene_image_hwc = None
            a, _, _, _, e, _ = self.image.transform
            self._image_pixel_size = np.array([a, -e], dtype=np.float64)
            shape = self.patch_size / self._image_pixel_size
            if not np.all(np.floor(shape) == shape):
                raise ValueError("patch size must be a multiple of the image pixel size")
            self._image_patch_shape = shape.astype(np.int64)
        self.chunk_info_ls: List[Dict] = []
        self.data: List[Dict] = []
        self.anchor_points: List[Dict] = []
        strip = (None if self.random_sample
                 else np.asarray(cfg_dataset["sliding_window"][f"{split}_strip"], np.float64))
        for k, ch in enumerate(chunks):
            pts = np.ascontiguousarray(ch["points"], dtype=np.float64)
            info = {"name": ch["name"], "min_bound": list(ch["min_bound"]),
                    "max_bound": list(ch["max_bound"])}
            self.chunk_info_ls.append(info)
            self.data.append({"name": ch["name"], "inputs": pts,
                              "index": GridIndex2D(pts, float(self.patch_size[0]) / 2.0,
                                                   native=self.native)})
            if self.random_sample:
                continue
            mn = np.asarray(info["min_bound"], dtype=np.float64)
            mx = np.asarray(info["max_bound"], dtype=np.float64)
            px = np.arange(mn[0], mx[0] - self.patch_size[0], strip[0])
            px = np.concatenate([px, [mx[0] - self.patch_size[0]]])
            py = np.arange(mn[1], mx[1] - self.patch_size[1], strip[1])
            py = np.concatenate([py, [mx[1] - self.patch_size[1]]])
            xv, yv = np.meshgrid(px, py)
            for anchor in np.stack([xv.ravel(), yv.ravel()], axis=1):
                self.anchor_points.append({"chunk": k, "anchor": anchor})

        xr, yr = norm["x_range"], norm["y_range"]
        self._min_norm_bound = [xr[0], yr[0]]
        self._max_norm_bound = [xr[1], yr[1]]
        z_bound = self.z_bound = norm["z_bound"]
        self.scale_mat = np.diag([self.patch_size[0] / (xr[1] - xr[0]),
                                  self.patch_size[1] / (yr[1] - yr[0]),
                                  z_bound[1] - z_bound[0], 1.0]).astype(np.float64)
        self.shift_norm = np.eye(4, dtype=np.float64)
        self.shift_norm[0, 3] = (xr[1] - xr[0]) / 2.0
        self.shift_norm[1, 3] = (yr[1] - yr[0]) / 2.0

    def __len__(self) -> int:
        return self.random_length if self.random_sample else len(self.anchor_points)

    def _normalize_points(self, inputs, min_bound, max_bound, normalize_mat):
        """World points -> float32 points strictly inside the normalized
        bounds (dataset.py:231-243): the world crop, the transform, the cast
        and the recrop in one C++ pass, or their numpy plain versions."""
        if self.native:
            return host_runtime.crop_transform_patch(inputs, min_bound, max_bound, normalize_mat,
                                               self._min_norm_bound, self._max_norm_bound)
        return plain.crop_transform_patch(inputs, min_bound, max_bound, normalize_mat,
                                          self._min_norm_bound, self._max_norm_bound)

    def scene_image_hwc(self) -> np.ndarray:
        """The whole scene image as one (H, W, C) array in the wire's dtype,
        for the device-crop wire: the generator uploads it once and slices
        each tile's crop on the card; ``scene[r0:r0 + h, c0:c0 + w][::-1]``
        is the host crop of the patch at ``image_origin`` (r0, c0)."""
        if not self.image_crop_device:
            raise ValueError("scene_image_hwc needs satellite_image.crop='device' on a "
                             "serving dataset")
        if self._scene_image_hwc is None:
            self._scene_image_hwc = np.ascontiguousarray(np.moveaxis(self.image_data, 0, -1))
        return self._scene_image_hwc

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        """Patch ``idx``; ``rng`` draws a random anchor and the augmentation
        (the global numpy generator when None, as the JAX dataset)."""
        r = rng if rng is not None else np.random
        if self.random_sample:
            k = idx % len(self.data)
            mn = np.asarray(self.chunk_info_ls[k]["min_bound"], dtype=np.float64)[:2]
            mx = np.asarray(self.chunk_info_ls[k]["max_bound"], dtype=np.float64)[:2]
            anchor = r.random(2) * (mx - mn - self.patch_size[:2])
            if self.image is not None:  # snap to the image pixel grid
                anchor = np.floor(anchor / self._image_pixel_size) * self._image_pixel_size
            anchor = anchor + mn
        else:
            k, anchor = self.anchor_points[idx]["chunk"], self.anchor_points[idx]["anchor"]
        chunk = self.data[k]
        min_bound = anchor.astype(np.float64)
        max_bound = min_bound + self.patch_size
        name = f"{chunk['name']}-patch{idx}"
        inputs, _ = chunk["index"].query(chunk["inputs"], min_bound, max_bound)
        if len(inputs) == 0:
            return {"name": name, "min_bound": min_bound.copy(),
                    "max_bound": max_bound.copy(), "is_valid": False}
        transform_mat = self.scale_mat.copy()
        transform_mat[0:2, 3] = (min_bound + max_bound) / 2.0
        transform_mat[2, 3] = (float(inputs[:, 2].min()) if self.z_shift == "local_min"
                               else float(self.z_bound[0]))
        # the augmentation's draws, in the JAX dataset's order (dataset.py:288-291)
        rot_times = int(r.choice(4)) if self.rotate_augm else 0
        flip_dim = int(r.choice([-1, 0, 1])) if self.flip_augm else -1
        normalize_mat = (self.shift_norm @ FLIP_MATRICES[flip_dim] @ ROT_MATRICES[rot_times]
                         @ invert_transform(transform_mat))
        out = {"name": name,
               "inputs": self._normalize_points(inputs, min_bound, max_bound, normalize_mat),
               "transform": invert_transform(normalize_mat),
               "min_bound": min_bound.copy(), "max_bound": max_bound.copy(),
               "flip": flip_dim, "rotate": rot_times, "is_valid": True}
        if self.image is not None:
            if self.image_crop_device:
                # the crop's origin in the scene image; the generator slices
                # and flips it on the card (the device crop implies no target)
                row0, col0 = self._crop_window(self.image, self._image_pixel_size,
                                               self._image_patch_shape, min_bound)
                h, w = self._image_patch_shape
                sh, sw = self.image_data.shape[1:]
                if not (0 <= row0 and row0 + h <= sh and 0 <= col0 and col0 + w <= sw):
                    raise ValueError(f"{name}: crop leaves the image")
                out["image_origin"] = np.array([row0, col0], dtype=np.int32)
                return out
            out["image"] = self._crop(self.image_data, self.image, self._image_pixel_size,
                                      self._image_patch_shape, min_bound, name, rot_times,
                                      flip_dim)
        if self.dsm is not None:
            out["dsm"] = self._crop(self.dsm_data[None], self.dsm, self._dsm_pixel_size,
                                    self._dsm_patch_shape, min_bound, name, rot_times,
                                    flip_dim)[..., 0]
        return out

    @staticmethod
    def _crop_window(raster, pixel_size, shape, min_bound):
        """(row0, col0) of the patch's crop: the anchor names the bottom-left
        pixel, so the rows north of it."""
        center = min_bound + pixel_size / 2.0
        col, row = raster.query_col_row(center[0], center[1])
        return int(row - shape[0] + 1), int(col)

    @classmethod
    def _crop(cls, data, raster, pixel_size, shape, min_bound, name, rot_times: int = 0,
              flip_dim: int = -1) -> np.ndarray:
        """The patch's (h, w, C) crop of a (C, H, W) raster in its dtype,
        rotated and flipped as the points, y-up."""
        row0, col0 = cls._crop_window(raster, pixel_size, shape, min_bound)
        h, w = shape
        crop = data[:, max(row0, 0): row0 + h, col0: col0 + w]
        if row0 < 0 or crop.shape[1:] != (h, w):
            raise ValueError(f"{name}: crop {crop.shape[1:]} leaves the raster")
        crop = augment_raster(crop, rot_times, flip_dim)
        return np.ascontiguousarray(np.moveaxis(crop[:, ::-1], 0, -1), dtype=data.dtype)


def augment_raster(chw: np.ndarray, rot_times: int, flip_dim: int) -> np.ndarray:
    """Rotate clockwise ``rot_times`` quarter turns, then flip (0: columns,
    as the points' x; 1: rows, as y): the reference's torch ``rot90(k,
    [-1, -2])`` / ``flip`` on CHW tensors (dataset.py:300-307, JAX
    ``_augment_raster``)."""
    out = chw
    if rot_times > 0:
        out = np.rot90(out, rot_times, axes=(2, 1))  # clockwise in (H, W)
    if flip_dim == 0:
        out = out[:, :, ::-1]
    elif flip_dim == 1:
        out = out[:, ::-1, :]
    return out
