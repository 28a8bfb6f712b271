"""The training loop: the port's counterpart of ``train.py:240-322``.

Batches are prepared one ahead: batch k+1's upload (pinned memory,
non-blocking) is enqueued before batch k's step, so the host's collate and
upload of the next batch overlap the card's work on the current one. Batches
with no valid patch are skipped. An iteration is one optimizer step
(``optimize_every`` mini-steps); iteration schedulers step once per
iteration, ReduceLROnPlateau on each validation; validation runs every
``validate_every`` iterations when a validation loader is given. Phase timers
(host clock) split each iteration into loader (collate + upload enqueue),
step (the mini-steps' launches; the card runs behind), log (the window's
metric read, which waits for the card) and aux (validation and
checkpoints). On a CUDA device every mini-step is also bracketed by CUDA
events; a window's events live until the window closes, where its mini-step
times are read into its record and the events dropped, so a long run holds
none past its window.

Checkpoints (``train/checkpoint.py``, train.py:191-299): with a
``CheckpointIO`` the loop registers the model, the trainer (its optimizer
state) and the scheduler, resumes from ``resume_from`` when that file
exists (``n_iter``, ``loss_val_best``, ``training_time`` and, under
``det_stream``, the loader's stream position), and after the scheduler's
step writes ``model_best.ckpt`` when validation improves on
``model_selection_metric`` and ``model_{n_iter}.ckpt`` every
``checkpoint_every`` iterations, from one read of the card an iteration.

Metrics (train.py:260-313): with a ``MetricLogger`` every iteration appends
one record at its end: ``iteration``, ``lr``, ``train/<metric>``,
``misc/training_time``, ``misc/time_<phase>_s``, ``val/<metric>`` when it
validated, the ``visualize`` callable's metrics (``nDSM/<mask>/<stat>``:
the entry point generates the vis split's nDSM and evaluates it) every
``visualize_every`` iterations, and at ``print_every`` the device's memory
(``misc/device_bytes_in_use``, ``misc/device_peak_bytes``, CUDA only) and
the host's RSS (``misc/host_rss_bytes``); the logger's ``watch`` adds the
per-module parameter norms. Visualization counts as aux time.

The loader's own prefetch thread and worker pool (``PatchLoader(prefetch=,
n_workers=)``) collate batches ahead of this loop; the loader phase then
times the wait for the next collated batch and its upload.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tomosar2height_tpu_torch.train.checkpoint import CheckpointIO
from tomosar2height_tpu_torch.train.schedule import ITERATION_SCHEDULERS, SchedulerBase
from tomosar2height_tpu_torch.train.trainer import Trainer

log = logging.getLogger(__name__)


def prepared_batches(loader, trainer: Trainer) -> Iterator[Tuple[dict, Optional[tuple], int]]:
    """Yield (prepared batch, stream position, valid patches), the upload of
    the next batch already started; batches without a valid patch are
    skipped."""
    nxt = None
    for batch in loader:
        pos = batch.pop("_stream_pos", None)
        n_valid = int(batch["patch_valid"].sum())
        if n_valid == 0:
            continue
        cur, nxt = nxt, (trainer.prepare_batch(batch), pos, n_valid)
        if cur is not None:
            yield cur
    if nxt is not None:
        yield nxt


def memory_metrics(device: torch.device) -> Dict[str, int]:
    """The device's allocated and peak bytes (CUDA) and the host's RSS."""
    out = {}
    if device.type == "cuda":
        out["misc/device_bytes_in_use"] = int(torch.cuda.memory_allocated(device))
        out["misc/device_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    with open("/proc/self/statm") as f:
        out["misc/host_rss_bytes"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return out


def train(trainer: Trainer, scheduler: SchedulerBase, train_loader, cfg_training: Dict,
          val_loader=None, max_iteration: Optional[int] = None,
          checkpoint_io: Optional[CheckpointIO] = None,
          resume_from: Optional[str] = None, metric_logger=None,
          visualize: Optional[Callable[[int], Dict[str, float]]] = None) -> Dict:
    """Run optimizer steps until iteration ``max_iteration`` (default
    ``cfg_training['max_iteration']``), counted from the checkpoint resumed.

    ``resume_from`` names a checkpoint file; a bare name (such as
    ``checkpoint.DEFAULT_MODEL_FILE``) is looked up in
    ``checkpoint_io.checkpoint_dir``. A missing file trains from scratch.
    ``metric_logger`` (a ``utils.logging.MetricLogger``) takes one record an
    iteration; ``visualize(n_iter)`` runs every ``visualize_every``
    iterations and returns metrics for the record (and ``vis``).

    Returns a dict: ``windows`` (one record per iteration: iteration, lr it trained
    with, the window's mean metrics, valid patches, phase seconds and, on a
    CUDA device, ``step_ms_median``: the median CUDA-event milliseconds of its
    mini-steps), ``val`` (validation records), ``vis`` (``visualize``'s
    records), ``step_ms`` (per-mini-step
    CUDA-event milliseconds on a CUDA device, else empty; read as each
    window closes), ``median_step_ms``, ``n_ministeps``, ``n_patches``
    (valid patches stepped), ``stream_pos``, ``loss_val_best``, ``n_iter``
    and ``resumed`` (whether a checkpoint was loaded).
    """
    t_start = time.time()
    max_iteration = int(max_iteration if max_iteration is not None
                        else cfg_training["max_iteration"])
    sched_type = cfg_training["scheduler"]["type"]
    validate_every = int(cfg_training.get("validate_every", 0) or 0)
    checkpoint_every = int(cfg_training.get("checkpoint_every", 0) or 0)
    print_every = int(cfg_training.get("print_every", 0) or 0)
    visualize_every = int(cfg_training.get("visualize_every", 0) or 0) if visualize else 0
    metric_key = cfg_training.get("model_selection_metric", "loss_l1")
    cuda = trainer.device.type == "cuda"
    events = []  # the open window's (start, end) CUDA events
    out = {"windows": [], "val": [], "vis": [], "step_ms": [], "n_ministeps": 0,
           "n_patches": 0,
           "stream_pos": None, "loss_val_best": float("inf"), "resumed": False}
    ph = dict.fromkeys(("loader", "step", "log", "aux"), 0.0)
    n_iter, time_before = 0, 0.0
    if checkpoint_io is not None:
        checkpoint_io.register_modules(model=trainer.model, optimizer=trainer,
                                       scheduler=scheduler)
        if resume_from:
            path = (resume_from if os.path.dirname(resume_from)
                    else os.path.join(checkpoint_io.checkpoint_dir, resume_from))
            try:
                loaded = checkpoint_io.load(
                    path, resume_scheduler=cfg_training.get("resume_scheduler", True))
            except FileNotFoundError:
                log.info("Training from scratch.")
            else:
                out["resumed"] = True
                n_iter = int(loaded.get("n_iter", 0))
                out["loss_val_best"] = float(loaded.get("loss_val_best", np.inf))
                time_before = float(loaded.get("training_time", 0.0))
                pos = loaded.get("stream_pos")
                if pos and getattr(train_loader, "det_stream", False):
                    train_loader.set_position(int(pos[0]), int(pos[1]))
                    out["stream_pos"] = (int(pos[0]), int(pos[1]))
                log.info("Resuming from %s at iteration %d.", path, n_iter)
    # model_best and model_{n} may fall on one iteration: read the card once
    snap = {"iter": None, "data": None}

    def save_ckpt(name: str):
        if snap["iter"] != n_iter:
            snap.update(iter=n_iter, data=checkpoint_io.snapshot())
        pos = out["stream_pos"]
        checkpoint_io.write(os.path.join(checkpoint_io.checkpoint_dir, name), snap["data"],
                            n_iter=n_iter, loss_val_best=out["loss_val_best"],
                            stream_pos=list(pos) if pos else None,
                            training_time=time.time() - t_start + time_before)

    window_patches = 0  # a window may span two passes of the loader
    while n_iter < max_iteration:
        n_before = out["n_ministeps"]
        batches = prepared_batches(train_loader, trainer)
        while n_iter < max_iteration:
            t0 = time.perf_counter()
            item = next(batches, None)
            if item is None:
                break
            batch, pos, n_valid = item
            t1 = time.perf_counter()
            ph["loader"] += t1 - t0
            lr = scheduler.lr
            if cuda:
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            trainer.train_step(batch, lr)
            if cuda:
                events[-1][1].record()
            ph["step"] += time.perf_counter() - t1
            out["n_ministeps"] += 1
            out["n_patches"] += n_valid
            window_patches += n_valid
            if pos is not None:
                out["stream_pos"] = pos
            if trainer.accumulated_steps != 0:
                continue
            n_iter += 1
            t_log = time.perf_counter()
            record = {"iteration": n_iter, "lr": lr, "loss": trainer.last_avg_loss,
                      **trainer.last_avg_loss_dict, "n_patches": window_patches}
            window_patches = 0
            if print_every and n_iter % print_every == 0:
                log.info("Iteration %d, Loss = %.5f", n_iter, record["loss"])
            if sched_type in ITERATION_SCHEDULERS:
                scheduler.step()
            t_aux = time.perf_counter()
            metrics = {}
            if val_loader is not None and validate_every and n_iter % validate_every == 0:
                val = trainer.evaluate(val_loader)
                out["val"].append({"iteration": n_iter, **val})
                metrics.update({f"val/{k}": v for k, v in val.items()})
                if sched_type == "ReduceLROnPlateau":
                    scheduler.step(val[metric_key])
                if val[metric_key] < out["loss_val_best"]:
                    out["loss_val_best"] = val[metric_key]
                    if checkpoint_io is not None:
                        save_ckpt("model_best.ckpt")
            if checkpoint_io is not None and checkpoint_every and n_iter % checkpoint_every == 0:
                save_ckpt(f"model_{n_iter}.ckpt")
            if visualize_every and n_iter % visualize_every == 0:
                vis = visualize(n_iter)
                out["vis"].append({"iteration": n_iter, **vis})
                metrics.update(vis)
            t_end = time.perf_counter()
            ph["log"], ph["aux"] = t_aux - t_log, t_end - t_aux
            if metric_logger is not None:
                if print_every and n_iter % print_every == 0:
                    metrics.update(memory_metrics(trainer.device))
                metric_logger.log({
                    "iteration": n_iter, "train/loss": record["loss"], "lr": lr,
                    **{f"train/{k}": v for k, v in trainer.last_avg_loss_dict.items()},
                    "misc/training_time": time.time() - t_start + time_before,
                    **{f"misc/time_{k}_s": v for k, v in ph.items()}, **metrics}, step=n_iter)
            if events:
                times = _event_ms(events)
                record["step_ms_median"] = float(np.median(times))
                out["step_ms"] += times
                events = []
            out["windows"].append({**record, **{f"time_{k}_s": v for k, v in ph.items()}})
            ph = dict.fromkeys(ph, 0.0)
        if out["n_ministeps"] == n_before:
            raise RuntimeError("the training loader yielded no batch with a valid patch")
    out["median_step_ms"] = float(np.median(out["step_ms"])) if out["step_ms"] else None
    out["n_iter"] = n_iter
    return out


def _event_ms(events) -> list:
    """Milliseconds between each (start, end) pair of CUDA events, once the
    last end has been reached."""
    events[-1][1].synchronize()
    return [float(s.elapsed_time(e)) for s, e in events]
