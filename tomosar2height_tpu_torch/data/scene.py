"""Patches of a scene held in memory, for serving and training.

The patch math of ``tomosar2height_tpu/data/dataset.py:TomoSARDataset``
without augmentation: sliding-window anchors (serving, validation) or random
anchors (training, dataset.py:252-261), the same float64 world ->
unit-square normalization with a per-patch z shift (``local_min``, the
patch's lowest point, or ``global_min``, the lower z bound;
dataset.py:244-301), the same crop index, with a GT nDSM raster the target
crop, flipped to y-up (dataset.py:337-346), and with a satellite image its
normalized crop, y-up and HWC (the f32 image wire,
dataset.py:84-92,112-115,316-335). A patch here is bit-identical to the JAX
dataset's numpy path (its C++ fast path for patches of >= 4096 points rounds
the same transform to within ~1e-7). Chunks come in as arrays and rasters;
:class:`~tomosar2height_tpu_torch.data.dataset.TomoSARDataset` reads them
from a built dataset on disk and hands them here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from tomosar2height_tpu_torch.geo import (
    GridIndex2D,
    apply_transform,
    crop_pc_2d,
    invert_transform,
)


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
        image: the satellite image as ``(data (C, H, W), raster)``, raw values
            normalized once here by ``cfg_dataset['satellite_image']
            ['normalize']`` (mean, std per channel, in float64, kept as f32);
            each valid patch then carries its crop ``image`` (h, w, C) f32,
            y-up, and random anchors snap to the image's pixel grid.
        flip_augm, rotate_augm: the JAX dataset's augmentations, not ported.
    """

    def __init__(self, chunks: Sequence[Dict], cfg_dataset: Dict, split: str = "test",
                 random_sample: bool = False, random_length: Optional[int] = None,
                 dsm=None, image=None, flip_augm: bool = False, rotate_augm: bool = False):
        if flip_augm or rotate_augm:
            raise NotImplementedError(
                "flip/rotate augmentation is not ported yet (ROADMAP: augmentation); the "
                "flagship trains with both off")
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
        if self.image is not None:
            norm_img = cfg_dataset["satellite_image"]["normalize"]
            mean = np.asarray(norm_img["mean"], dtype=np.float64)[:, None, None]
            std = np.asarray(norm_img["std"], dtype=np.float64)[:, None, None]
            self.image_data = ((np.asarray(self.image_data, dtype=np.float64) - mean)
                               / std).astype(np.float32)
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
                              "index": GridIndex2D(pts, cell_size=float(self.patch_size[0]) / 2.0)})
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

    def _normalize_points(self, inputs, normalize_mat):
        inputs_norm = apply_transform(inputs, normalize_mat).astype(np.float32)
        inputs_norm, _ = crop_pc_2d(inputs_norm, self._min_norm_bound, self._max_norm_bound)
        return inputs_norm

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        """Patch ``idx``; ``rng`` draws a random anchor (the global numpy
        generator when None, as the JAX dataset)."""
        if self.random_sample:
            k = idx % len(self.data)
            mn = np.asarray(self.chunk_info_ls[k]["min_bound"], dtype=np.float64)[:2]
            mx = np.asarray(self.chunk_info_ls[k]["max_bound"], dtype=np.float64)[:2]
            rand = (rng if rng is not None else np.random).random(2)
            anchor = rand * (mx - mn - self.patch_size[:2])
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
        # the JAX dataset's flip and rotation are identities when serving
        normalize_mat = self.shift_norm @ invert_transform(transform_mat)
        out = {"name": name, "inputs": self._normalize_points(inputs, normalize_mat),
               "min_bound": min_bound.copy(), "max_bound": max_bound.copy(),
               "is_valid": True}
        if self.image is not None:
            out["image"] = self._crop(self.image_data, self.image, self._image_pixel_size,
                                      self._image_patch_shape, min_bound, name)
        if self.dsm is not None:
            out["dsm"] = self._crop(self.dsm_data[None], self.dsm, self._dsm_pixel_size,
                                    self._dsm_patch_shape, min_bound, name)[..., 0]
        return out

    @staticmethod
    def _crop(data, raster, pixel_size, shape, min_bound, name) -> np.ndarray:
        """The patch's (h, w, C) f32 crop of a (C, H, W) raster, y-up: the
        anchor names the bottom-left pixel, so the rows north of it."""
        center = min_bound + pixel_size / 2.0
        col, row = raster.query_col_row(center[0], center[1])
        h, w = shape
        crop = data[:, row - h + 1: row + 1, col: col + w]
        if crop.shape[1:] != (h, w):
            raise ValueError(f"{name}: crop {crop.shape[1:]} leaves the raster")
        return np.ascontiguousarray(np.moveaxis(crop[:, ::-1], 0, -1), dtype=np.float32)
