"""Build the chunked dataset of a city (counterpart of the JAX package's
``scripts/build_dataset.py``)::

    python -m tomosar2height_tpu_torch.cli.build_dataset dataset=synthetic \
        [--overwrite] [key=value ...]

Composes the same config tree as ``train`` and ``test``; the work is
:func:`tomosar2height_tpu_torch.data.build_dataset`.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Dict, List, Optional

from tomosar2height_tpu_torch.config import compose, default_conf_dir
from tomosar2height_tpu_torch.data import build_dataset
from tomosar2height_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("build")


def main(overrides: Optional[List[str]] = None) -> Dict[int, dict]:
    """Build from ``overrides`` (default ``sys.argv[1:]``; ``--overwrite``
    replaces an existing output folder). Returns the chunk info."""
    args = list(sys.argv[1:] if overrides is None else overrides)
    setup_logging()
    cfg = compose(default_conf_dir(), overrides=[a for a in args if a != "--overwrite"])
    t0 = time.perf_counter()
    info = build_dataset(cfg, overwrite="--overwrite" in args)
    log.info("Built %d chunks in %.3f s.", len(info), time.perf_counter() - t0)
    return info


if __name__ == "__main__":
    main()
