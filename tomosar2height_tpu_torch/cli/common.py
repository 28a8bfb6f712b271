"""What the entry points share: the run directory and the loader's layout."""

from __future__ import annotations

import os
from typing import Dict

from tomosar2height_tpu_torch.data import tile_cells_for_impl


def run_dir(cfg) -> str:
    """``<training.out_dir>/<training.run_name><run_suffix>``."""
    tcfg = cfg["training"]
    return os.path.join(tcfg["out_dir"], f"{tcfg['run_name']}{cfg['run_suffix']}")


def loader_kwargs(cfg) -> Dict:
    """PatchLoader's bucket and layout arguments from the config
    (train.py:128-150): with ``dataset.points.sort`` the Morton layout that
    ``model.encoder_kwargs.sorted_impl`` reads (aligned with 256-cell tiles
    for ``fused``, 1024 for ``fused2``; the plain sorted layout otherwise).
    The u16 point wire and the loader's worker pool are ROADMAP: wires and
    the host side; ``dataloader.prefetch`` is read and not needed (the loop
    and the generator upload one batch ahead)."""
    points = cfg["dataset"]["points"]
    wire = str(points.get("wire", "float32"))
    workers = int((cfg.get("dataloader") or {}).get("n_workers", 0) or 0)
    if wire != "float32" or workers:
        raise NotImplementedError(f"dataset.points.wire={wire!r}, dataloader.n_workers="
                                  f"{workers}: ROADMAP: wires and the host side")
    enc = cfg["model"]["encoder_kwargs"]
    sort = (bool(points.get("sort", False)) and bool(cfg["use_cloud"])
            and cfg["model"]["encoder"] == "pointnet_local_pool")
    impl = enc.get("sorted_impl", "cumsum")
    return dict(bucket_sizes=points["bucket_sizes"], fixed_bucket=points["train_bucket"],
                sort_reso=enc["plane_resolution"] if sort else None,
                aligned=impl in ("fused", "fused2"), tile_cells=tile_cells_for_impl(impl))
