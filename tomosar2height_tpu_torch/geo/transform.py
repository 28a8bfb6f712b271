"""4x4 homogeneous point transforms (float64) and the 2D affine geo-transform.
Counterpart of ``tomosar2height_tpu/geo/transform.py`` (``apply_transform``,
``invert_transform``, ``Affine``, the augmentation's ``ROT_MATRICES`` and
``FLIP_MATRICES``), with the same arithmetic."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


class Affine:
    """2D affine geo-transform ``x = a*col + b*row + c``, ``y = d*col + e*row + f``
    (the GDAL/rasterio coefficient order): application, inversion (``~T``),
    composition and application to a pair (``T * (col, row)``), equality."""

    __slots__ = ("a", "b", "c", "d", "e", "f")

    def __init__(self, a: float, b: float, c: float, d: float, e: float, f: float):
        self.a, self.b, self.c = float(a), float(b), float(c)
        self.d, self.e, self.f = float(d), float(e), float(f)

    def coefficients(self):
        return (self.a, self.b, self.c, self.d, self.e, self.f)

    def __invert__(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0.0:
            raise ValueError("Affine transform is not invertible")
        ia, ib, id_, ie = self.e / det, -self.b / det, -self.d / det, self.a / det
        return Affine(ia, ib, -(ia * self.c + ib * self.f),
                      id_, ie, -(id_ * self.c + ie * self.f))

    def __mul__(self, other):
        if isinstance(other, Affine):
            return Affine(
                self.a * other.a + self.b * other.d,
                self.a * other.b + self.b * other.e,
                self.a * other.c + self.b * other.f + self.c,
                self.d * other.a + self.e * other.d,
                self.d * other.b + self.e * other.e,
                self.d * other.c + self.e * other.f + self.f)
        x, y = other
        return (self.a * x + self.b * y + self.c, self.d * x + self.e * y + self.f)

    def apply(self, xy: np.ndarray) -> np.ndarray:
        """Apply to an (N, 2) float64 array of coordinates; returns (N, 2)."""
        xy = np.asarray(xy, dtype=np.float64)
        out = np.empty_like(xy)
        out[:, 0] = self.a * xy[:, 0] + self.b * xy[:, 1] + self.c
        out[:, 1] = self.d * xy[:, 0] + self.e * xy[:, 1] + self.f
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, Affine):
            return NotImplemented
        return all(math.isclose(p, q, rel_tol=1e-12, abs_tol=1e-9)
                   for p, q in zip(self.coefficients(), other.coefficients()))

    def __hash__(self):
        return hash(self.coefficients())

    def __repr__(self):
        return f"Affine(a={self.a}, b={self.b}, c={self.c}, d={self.d}, e={self.e}, f={self.f})"


def apply_transform(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points (with w-divide)."""
    p = np.asarray(points, dtype=np.float64)
    hom = np.concatenate([p, np.ones((p.shape[0], 1), dtype=np.float64)], axis=1)
    out = hom @ np.asarray(m, dtype=np.float64).T
    return out[:, :3] / out[:, 3:4]


def transform_points(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(N, 3) points through a 4x4 homogeneous transform, row by row as
    ``m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]`` summed left to right
    in float64, divided by w only where the last row is not (0, 0, 0, 1): the
    C++ runtime's order, so the two agree bit for bit (:func:`apply_transform`
    goes through a BLAS product, whose order and fused multiply-adds are the
    library's; the two agree to within an ulp)."""
    p = np.asarray(points, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = np.empty((p.shape[0], 3), dtype=np.float64)
    for i in range(3):
        out[:, i] = m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]
    if not np.array_equal(m[3], [0.0, 0.0, 0.0, 1.0]):
        out /= (m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3])[:, None]
    return out


def invert_transform(m: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 homogeneous transform."""
    return np.linalg.inv(np.asarray(m, dtype=np.float64))


def rotation_matrix_z(angle_rad: float) -> np.ndarray:
    """4x4 homogeneous rotation about the +z axis (right-handed, CCW positive)."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def reflection_matrix(normal: Sequence[float]) -> np.ndarray:
    """4x4 householder reflection through the plane with unit ``normal`` at the origin."""
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] -= 2.0 * np.outer(n, n)
    return m


# 90-degree clockwise rotations about z (k quarter turns), reference dataset.py:30-35
ROT_MATRICES: Dict[int, np.ndarray] = {
    k: rotation_matrix_z(-k * math.pi / 2.0) for k in range(4)
}

# Axis flips: -1 identity, 0 -> x := -x, 1 -> y := -y, reference dataset.py:38-42
FLIP_MATRICES: Dict[int, np.ndarray] = {
    -1: np.eye(4, dtype=np.float64),
    0: reflection_matrix([1.0, 0.0, 0.0]),
    1: reflection_matrix([0.0, 1.0, 0.0]),
}
