"""What the entry points share: the run directory."""

from __future__ import annotations

import os


def run_dir(cfg) -> str:
    """``<training.out_dir>/<training.run_name><run_suffix>``."""
    tcfg = cfg["training"]
    return os.path.join(tcfg["out_dir"], f"{tcfg['run_name']}{cfg['run_suffix']}")
