"""The patch source over a built dataset on disk.

Counterpart of ``tomosar2height_tpu/data/dataset.py:TomoSARDataset`` with
its arguments: it reads the builder's ``chunk_info.yaml`` and each chunk's
``input_point_cloud.npz`` under ``cfg_dataset['path']``, the GT nDSM
(``dsm_gt_path``) and the satellite image (``satellite_image.folder`` /
``pairs``), and hands them to :class:`SceneDataset`, whose patch math is the
JAX dataset's: flip/rotate augmentation, the f32 or u8 image wire
(``satellite_image.wire``) and the host or device crop
(``satellite_image.crop``). Not here yet: stereo image pairs (ROADMAP:
alternates), which raise.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import yaml

from tomosar2height_tpu_torch.data.scene import SceneDataset
from tomosar2height_tpu_torch.geo import RasterReader

INPUT_POINT_CLOUD = "input_point_cloud.npz"
CHUNK_INFO = "chunk_info.yaml"


class TomoSARDataset(SceneDataset):
    """Patches of one split ('train', 'val', 'vis' or 'test') of a built
    dataset. ``load_target=False`` skips the GT nDSM crop (the generator's
    loaders), ``load_image=False`` the satellite image (cloud-only runs)."""

    def __init__(self, split: str, cfg_dataset: Dict, random_sample: bool = False,
                 random_length: Optional[int] = None, flip_augm: bool = False,
                 rotate_augm: bool = False, load_target: bool = True,
                 load_image: bool = True):
        dataset_dir = cfg_dataset["path"]
        with open(os.path.join(dataset_dir, CHUNK_INFO)) as f:
            self.chunk_info: Dict[int, dict] = yaml.safe_load(f)
        image = None
        images_dic = cfg_dataset.get("satellite_image") if load_image else None
        if images_dic is not None:
            pairs = list(images_dic["pairs"])
            if len(pairs) != 1:
                raise NotImplementedError(f"satellite_image.pairs={pairs}: stereo image "
                                          "pairs are ROADMAP: alternates")
            reader = RasterReader(os.path.join(images_dic["folder"], pairs[0]))
            image = (np.stack([reader.get_data(b) for b in (1, 2, 3)]), reader)
        dsm = None
        if load_target:
            reader = RasterReader(cfg_dataset["dsm_gt_path"])
            dsm = (reader.get_data(1).astype(np.float32), reader)
        chunks = []
        for idx in cfg_dataset[f"{split}_chunks"]:
            info = self.chunk_info[idx]
            with np.load(os.path.join(dataset_dir, info["name"], INPUT_POINT_CLOUD)) as z:
                pts = z["pts"].astype(np.float64)
            chunks.append({"name": info["name"], "min_bound": info["min_bound"],
                           "max_bound": info["max_bound"], "points": pts})
        super().__init__(chunks, cfg_dataset, split, random_sample=random_sample,
                         random_length=random_length, dsm=dsm, image=image,
                         flip_augm=flip_augm, rotate_augm=rotate_augm)
