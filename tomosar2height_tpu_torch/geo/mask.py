"""Binary mask morphology (host). Counterpart of
``tomosar2height_tpu/geo/mask.py``."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dilate_mask(mask_in: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary dilation with scipy's default 4-connected structuring element,
    ``iterations`` times; returns a bool array."""
    return ndimage.binary_dilation(np.asarray(mask_in).astype(bool), iterations=iterations)
