"""Deterministic seeding. Counterpart of ``tomosar2height_tpu/utils/seeding.py``
(reference utils/lock_seed.py): Python's ``random``, numpy's global
generator (the patch sampler's when it is given no generator) and torch's
generators, the card's included."""

from __future__ import annotations

import random

import numpy as np
import torch


def lock_seed(seed: int = 0) -> int:
    """Seed the host generators and torch's (CPU and every card). Returns
    the seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
