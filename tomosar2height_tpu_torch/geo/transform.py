"""4x4 homogeneous point transforms (float64) and the 2D affine geo-transform.
Counterpart of ``tomosar2height_tpu/geo/transform.py`` (``apply_transform``,
``invert_transform``, ``Affine``), with the same arithmetic."""

from __future__ import annotations

import math

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


def invert_transform(m: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 homogeneous transform."""
    return np.linalg.inv(np.asarray(m, dtype=np.float64))
