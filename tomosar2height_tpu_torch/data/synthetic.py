"""A synthetic mini-city for runs without survey data.

The scene of ``scripts/make_synthetic_city.py`` (same seed, same draws, so
the same nDSM, masks and points): box buildings of random size and height
on flat ground, a TomoSAR-like cloud of roof and ground points with gaussian
vertical scatter and 1% gross outliers, and an RGB "satellite" image loosely
correlated with the heights. :func:`write_city` writes it as the script's
files, which ``conf/dataset/synthetic.yaml`` names.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tomosar2height_tpu_torch.geo import RasterData, save_las

X0, Y0 = 0.0, 5000000.0  # world origin (m) of the scene's south-west corner


def build_city(seed: int = 0, density: float = 0.6, n_buildings: int = 90,
               W: int = 1280, H: int = 640):
    """Returns (ndsm (H, W) f32 at 1 m, row 0 north; points (n, 3) f64 world
    coordinates, n = int(density * W * H); rgb (3, H, W) f32 of integral
    u8-range values, row 0 north)."""
    ndsm, _, _, pts, rgb = _city(seed, density, n_buildings, W, H)
    return ndsm, pts, rgb


def _city(seed, density, n_buildings, W, H):
    """build_city's scene with the building footprint (u8 0/1) and class
    (u8: 1 below 25 m, 2 above) masks."""
    rng = np.random.default_rng(seed)
    ndsm = np.zeros((H, W), dtype=np.float32)
    footprint = np.zeros((H, W), dtype=np.uint8)
    btype = np.zeros((H, W), dtype=np.uint8)
    for _ in range(n_buildings):
        bw = rng.integers(12, 60)
        bh = rng.integers(12, 60)
        cx = rng.integers(5, W - bw - 5)
        cy = rng.integers(5, H - bh - 5)
        height = rng.uniform(4.0, 55.0)
        ndsm[cy:cy + bh, cx:cx + bw] = np.maximum(ndsm[cy:cy + bh, cx:cx + bw], height)
        footprint[cy:cy + bh, cx:cx + bw] = 1
        btype[cy:cy + bh, cx:cx + bw] = 1 if height < 25 else 2

    n_pts = int(density * W * H)
    xs = rng.uniform(0, W, n_pts)
    ys = rng.uniform(0, H, n_pts)
    # raster row 0 is north (max y): world y = Y0 + (H - row)
    cols = np.clip(xs.astype(int), 0, W - 1)
    rows = np.clip(H - 1 - ys.astype(int), 0, H - 1)
    z = ndsm[rows, cols].astype(np.float64)
    z += rng.normal(0, 0.8, n_pts)
    out = rng.random(n_pts) < 0.01
    z[out] += rng.uniform(-15, 30, out.sum())
    rgb = np.zeros((3, H, W), dtype=np.float32)
    rgb[0] = 90 + 2.2 * ndsm + rng.normal(0, 12, (H, W))
    rgb[1] = 110 + 1.5 * ndsm + rng.normal(0, 12, (H, W))
    rgb[2] = 120 - 0.8 * ndsm + rng.normal(0, 12, (H, W))
    rgb = np.round(np.clip(rgb, 0, 255))
    return ndsm, footprint, btype, np.stack([X0 + xs, Y0 + ys, z], axis=1), rgb


def write_city(out_root: str, seed: int = 0, density: float = 0.6, W: int = 1280,
               H: int = 640, epsg: int = 25832, n_buildings: Optional[int] = None) -> dict:
    """Write the city as ``scripts/make_synthetic_city.py`` does, with the
    same bytes: ``raster/{ndsm,footprint,building_class,rgb}.tif`` (float32
    GeoTIFFs at 1 m, the masks as 0/1 and 0/1/2) and ``cloud/city.las``;
    ``n_buildings`` buildings, by default the script's ``90 * W * H / (1280 *
    640)``, at least 10. Returns the paths and the counts."""
    raster_dir = os.path.join(out_root, "raster")
    cloud_dir = os.path.join(out_root, "cloud")
    os.makedirs(raster_dir, exist_ok=True)
    os.makedirs(cloud_dir, exist_ok=True)
    n_b = n_buildings if n_buildings is not None else max(90 * (W * H) // (1280 * 640), 10)
    ndsm, footprint, btype, pts, rgb = _city(seed, density, n_b, W, H)
    paths = {}
    for name, data in (("ndsm", ndsm), ("footprint", footprint),
                       ("building_class", btype), ("rgb", rgb)):
        raster = RasterData([X0, Y0], [X0 + W, Y0 + H], [1, 1], epsg)
        for b, band in enumerate(data.reshape(-1, H, W)):
            raster.set_data(band.astype(np.float32), band=b + 1)
        paths[name] = os.path.join(raster_dir, f"{name}.tif")
        raster.write_to_file(paths[name])
    paths["cloud"] = os.path.join(cloud_dir, "city.las")
    save_las(paths["cloud"], pts)
    return {**paths, "n_points": len(pts), "n_buildings": n_b}
