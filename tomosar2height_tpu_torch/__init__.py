"""TomoSAR2Height on PyTorch and CUDA: the port of ``tomosar2height_tpu`` to an
NVIDIA Hopper card (H100).

The JAX package stays the reference; every module here has a counterpart of
the same name there (``config/``, ``ops/``, ``models/``, ``data/``,
``infer/``, ``train/``, ``utils/``, ``geo/``), and ``cli/`` holds the
counterparts of its ``scripts/build_dataset.py``, ``train.py`` and
``test.py``. This package imports ``torch``, numpy, scipy, PyYAML, msgpack,
tabulate and the standard library, and nothing of ``jax``, ``flax`` or the
JAX package; its host code (geo math, GeoTIFF and point-cloud files, Morton
layout, blend, evaluation) is numpy.

The Pallas kernels of the JAX package are CUDA C++ kernels for ``sm_90a``
under ``csrc/``, built with ``nvcc`` on first use (``ops/cuda/``).
"""

__version__ = "0.1.0"
