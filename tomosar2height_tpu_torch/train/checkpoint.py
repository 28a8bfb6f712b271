"""Checkpoints in the JAX package's file format, written and read without
flax or JAX.

Counterpart of ``tomosar2height_tpu/train/checkpoint.py`` (reference
utils/io_checkpoint.py:11-115): registered modules, scalar metadata
(``n_iter``, ``loss_val_best``, ``training_time``, ``stream_pos``), the
``model_best`` default file, ``resume_scheduler=False``, atomic writes and
lenient loads (a missing or unloadable entry is logged and skipped).

The file is the JAX package's: the msgpack of ``{"pytrees": {name: bytes},
"scalars": {...}}``, each pytree the msgpack of its state dict with every
array as msgpack extension type 1 holding the msgpack of ``(shape, dtype
name, C-order bytes)`` (flax ``serialization._ndarray_to_bytes``). Each
registered value goes in as follows:

- a ``torch.nn.Module`` (``model``): its flax parameter tree
  (``utils/torch_port.state_dict_to_flax``);
- a :class:`~tomosar2height_tpu_torch.train.trainer.Trainer`
  (``optimizer``): optax's optimizer state (``torch_port.optimizer_to_optax``);
- an object with ``state_dict``/``load_state_dict`` (a scheduler): its state
  dict among the scalars, as the JAX package stores it;
- a nested dict of arrays: as it is.

So one file is a checkpoint of both packages. Downloading a checkpoint by URL
needs the network and is not ported (ROADMAP: datasets on disk).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import msgpack
import numpy as np
import torch

from tomosar2height_tpu_torch.train.trainer import Trainer
from tomosar2height_tpu_torch.utils.torch_port import (
    load_flax_params,
    load_optax_state,
    optimizer_to_optax,
    sort_tree,
    state_dict_to_flax,
)

log = logging.getLogger(__name__)

DEFAULT_MODEL_FILE = "model_best.ckpt"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_LEAF_BYTES = 2 ** 30  # flax splits larger arrays into chunks; no leaf here is one


def _array_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be stored")
    if a.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"an array of {a.nbytes} bytes needs flax's chunked layout")
    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    if isinstance(x, tuple):
        return list(x)
    raise TypeError(f"cannot store {type(x).__name__} in a checkpoint")


def _array_from(data: bytes) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from(data)
    if code == _EXT_NPSCALAR:
        return _array_from(data)[()]
    return msgpack.ExtType(code, data)


def pack(tree) -> bytes:
    """msgpack of a tree of dicts, lists, Python scalars and numpy arrays, as
    flax's ``msgpack_serialize`` writes it (tuples as lists)."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def unpack(blob: bytes):
    """Inverse of :func:`pack` (flax's ``msgpack_restore``)."""
    return msgpack.unpackb(blob, ext_hook=_ext_unpack, raw=False)


def _to_tree(v):
    if isinstance(v, torch.nn.Module):
        return sort_tree(state_dict_to_flax(v.state_dict()))
    if isinstance(v, Trainer):
        return optimizer_to_optax(v)
    return v


def _from_tree(v, tree):
    if isinstance(v, torch.nn.Module):
        load_flax_params(v, tree)
        return v
    if isinstance(v, Trainer):
        load_optax_state(v, tree)
        return v
    return tree


class CheckpointIO:
    """Save and load registered modules and scalars (see the module
    docstring for what each registered value becomes)."""

    def __init__(self, checkpoint_dir: str, **modules):
        self.checkpoint_dir = checkpoint_dir
        self.module_dict: Dict[str, Any] = dict(modules)
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **modules):
        self.module_dict.update(modules)

    def snapshot(self) -> Dict[str, Any]:
        """Every registered value as it goes into a file: pytree bytes and
        state dicts. This is where the card is read; :meth:`write` it to as
        many files as needed."""
        pytrees, states = {}, {}
        for k, v in self.module_dict.items():
            if v is None:
                continue
            if hasattr(v, "state_dict") and not isinstance(v, torch.nn.Module):
                states[k] = v.state_dict()
            else:
                pytrees[k] = pack(_to_tree(v))
        return {"pytrees": pytrees, "scalars": states}

    def write(self, filename: str, snapshot: Dict[str, Any], **scalars):
        """Write a :meth:`snapshot` and ``scalars`` to ``filename``
        atomically (``.tmp`` then ``os.replace``)."""
        payload = sort_tree({"pytrees": snapshot["pytrees"],
                             "scalars": {**scalars, **snapshot["scalars"]}})
        tmp = filename + ".tmp"
        with open(tmp, "wb") as f:
            f.write(pack(payload))
        os.replace(tmp, filename)

    def save(self, filename: str, **scalars):
        self.write(filename, self.snapshot(), **scalars)

    def load(self, filename: str, resume_scheduler: bool = True) -> Dict[str, Any]:
        """Load ``filename`` into the registered values (modules and trainers
        in place; a registered tree is replaced in :attr:`module_dict`) and
        return the scalars that are not registered values."""
        if filename and filename.startswith(("http://", "https://")):
            raise NotImplementedError("loading a checkpoint by URL needs the network "
                                      "(ROADMAP: datasets on disk)")
        if not filename or not os.path.exists(filename):
            raise FileNotFoundError(f"Checkpoint file {filename} not found.")
        log.info("Loading checkpoint from local file...")
        with open(filename, "rb") as f:
            payload = unpack(f.read())
        scalars = dict(payload.get("scalars", {}))
        pytrees = payload.get("pytrees", {})
        for k, v in list(self.module_dict.items()):
            if v is None:
                continue
            if k == "scheduler" and not resume_scheduler:
                log.info("Skip loading scheduler from checkpoint.")
                scalars.pop(k, None)
                continue
            try:
                if hasattr(v, "load_state_dict") and not isinstance(v, torch.nn.Module):
                    v.load_state_dict(scalars.pop(k))
                elif k in pytrees:
                    self.module_dict[k] = _from_tree(v, unpack(pytrees[k]))
                else:
                    log.warning("Warning: Could not find %s in checkpoint!", k)
            except KeyError:
                log.warning("Warning: Could not find %s in checkpoint!", k)
            except (ValueError, TypeError, RuntimeError):  # shapes or types differ
                log.warning("Warning: Could not load %s in checkpoint!", k)
        return {k: v for k, v in scalars.items() if k not in self.module_dict}
