"""A synthetic mini-city for serving runs without survey data.

The scene of ``scripts/make_synthetic_city.py:build_city`` (same seed, same
draws, so the same nDSM and points): box buildings of random size and height
on flat ground, a TomoSAR-like cloud of roof and ground points with gaussian
vertical scatter and 1% gross outliers, and an RGB "satellite" image loosely
correlated with the heights. The script's masks and files are left out.
"""

from __future__ import annotations

import numpy as np

X0, Y0 = 0.0, 5000000.0  # world origin (m) of the scene's south-west corner


def build_city(seed: int = 0, density: float = 0.6, n_buildings: int = 90,
               W: int = 1280, H: int = 640):
    """Returns (ndsm (H, W) f32 at 1 m, row 0 north; points (n, 3) f64 world
    coordinates, n = int(density * W * H); rgb (3, H, W) f32 of integral
    u8-range values, row 0 north)."""
    rng = np.random.default_rng(seed)
    ndsm = np.zeros((H, W), dtype=np.float32)
    for _ in range(n_buildings):
        bw = rng.integers(12, 60)
        bh = rng.integers(12, 60)
        cx = rng.integers(5, W - bw - 5)
        cy = rng.integers(5, H - bh - 5)
        height = rng.uniform(4.0, 55.0)
        ndsm[cy:cy + bh, cx:cx + bw] = np.maximum(ndsm[cy:cy + bh, cx:cx + bw], height)

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
    return ndsm, np.stack([X0 + xs, Y0 + ys, z], axis=1), rgb
