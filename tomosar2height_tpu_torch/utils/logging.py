"""Console/file logging and a wandb-compatible metric logger. Counterpart of
``tomosar2height_tpu/utils/logging.py``: ``MetricLogger`` has wandb's
``init``/``watch``/``log``/``finish`` and appends every record as a JSON line
to ``<dir>/metrics.jsonl`` (and to wandb when it is asked for and
installed)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

_FMT = "%(asctime)s - %(levelname)s - %(filename)s - %(funcName)s >> %(message)s"


def setup_logging(log_file: Optional[str] = None, console_level: int = logging.INFO,
                  file_level: int = logging.DEBUG, fmt: str = _FMT) -> None:
    """The root logger to the console at ``console_level`` and, with
    ``log_file``, to that file at ``file_level``; earlier stream and file
    handlers are replaced."""
    root = logging.getLogger()
    root.setLevel(min(console_level, file_level))
    root.handlers = [h for h in root.handlers
                     if not isinstance(h, (logging.StreamHandler, logging.FileHandler))]
    ch = logging.StreamHandler()
    ch.setLevel(console_level)
    ch.setFormatter(logging.Formatter(fmt))
    root.addHandler(ch)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(file_level)
        fh.setFormatter(logging.Formatter(fmt))
        root.addHandler(fh)


class MetricLogger:
    """wandb-compatible metric sink writing JSONL."""

    def __init__(self):
        self._file = None
        self._wandb = None
        self._norms_fn: Optional[Callable[[], Dict[str, float]]] = None
        self._watch_freq = 100

    def init(self, project: str, config: Dict[str, Any], name: str, dir: str,
             mode: str = "disabled") -> "MetricLogger":
        """Open ``<dir>/metrics.jsonl`` for appending and write the run's
        config as its ``init`` record; ``mode='online'`` also starts wandb
        where it is installed."""
        os.makedirs(dir, exist_ok=True)
        self._file = open(os.path.join(dir, "metrics.jsonl"), "a")
        self._write({"_event": "init", "project": project, "name": name,
                     "time": time.time(), "config": _jsonable(config)})
        if mode != "disabled":
            try:
                import wandb  # type: ignore
            except ImportError:
                logging.getLogger(__name__).warning("wandb requested but not installed; "
                                                    "JSONL only")
            else:
                self._wandb = wandb
                wandb.init(project=project, config=config, name=name, dir=dir, mode="online")
        return self

    def watch(self, norms_fn: Callable[[], Dict[str, float]], log_freq: int = 100) -> None:
        """Every ``log_freq``-th logged step also records
        ``watch/param_norm/<module>``: ``norms_fn()`` returns the per-module
        parameter norms, reduced on the device and read once
        (``Trainer.module_norms``)."""
        self._norms_fn = norms_fn
        self._watch_freq = max(int(log_freq), 1)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._file is None:
            return
        if self._norms_fn is not None and step is not None and step % self._watch_freq == 0:
            metrics = {**metrics, **{f"watch/param_norm/{k}": float(v)
                                     for k, v in self._norms_fn().items()}}
        self._write({"_step": step, "time": time.time(), **_jsonable(metrics)})
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def _write(self, rec: Dict[str, Any]) -> None:
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):  # numpy and torch scalars
        return obj.item()
    return str(obj)
