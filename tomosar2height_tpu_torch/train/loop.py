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
metric read, which waits for the card) and aux (validation). On a CUDA device
every mini-step is also bracketed by CUDA events; a window's events live
until the window closes, where its mini-step times are read into its record
and the events dropped, so a long run holds none past its window.

Not here yet: checkpoints and resume (ROADMAP: checkpoints), ``visualize()``
with the DSMEvaluator (ROADMAP: evaluation), the wandb logger, prefetch
threads and worker pools (ROADMAP: wires and the host side).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

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


def train(trainer: Trainer, scheduler: SchedulerBase, train_loader, cfg_training: Dict,
          val_loader=None, max_iteration: Optional[int] = None) -> Dict:
    """Run optimizer steps until ``max_iteration`` (default
    ``cfg_training['max_iteration']``).

    Returns a dict: ``windows`` (one record per iteration: iteration, lr it trained
    with, the window's mean metrics, phase seconds and, on a CUDA device,
    ``step_ms_median``: the median CUDA-event milliseconds of its
    mini-steps), ``val`` (validation records), ``step_ms`` (per-mini-step
    CUDA-event milliseconds on a CUDA device, else empty; read as each
    window closes), ``median_step_ms``, ``n_ministeps``, ``n_patches``
    (valid patches stepped), ``stream_pos`` and ``loss_val_best``.
    """
    max_iteration = int(max_iteration if max_iteration is not None
                        else cfg_training["max_iteration"])
    sched_type = cfg_training["scheduler"]["type"]
    validate_every = int(cfg_training.get("validate_every", 0) or 0)
    print_every = int(cfg_training.get("print_every", 0) or 0)
    metric_key = cfg_training.get("model_selection_metric", "loss_l1")
    cuda = trainer.device.type == "cuda"
    events = []  # the open window's (start, end) CUDA events
    out = {"windows": [], "val": [], "step_ms": [], "n_ministeps": 0, "n_patches": 0,
           "stream_pos": None, "loss_val_best": float("inf")}
    ph = dict.fromkeys(("loader", "step", "log", "aux"), 0.0)
    n_iter = 0
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
            if pos is not None:
                out["stream_pos"] = pos
            if trainer.accumulated_steps != 0:
                continue
            n_iter += 1
            t_log = time.perf_counter()
            record = {"iteration": n_iter, "lr": lr, "loss": trainer.last_avg_loss,
                      **trainer.last_avg_loss_dict}
            if print_every and n_iter % print_every == 0:
                log.info("Iteration %d, Loss = %.5f", n_iter, record["loss"])
            if sched_type in ITERATION_SCHEDULERS:
                scheduler.step()
            t_aux = time.perf_counter()
            if val_loader is not None and validate_every and n_iter % validate_every == 0:
                val = trainer.evaluate(val_loader)
                out["val"].append({"iteration": n_iter, **val})
                if sched_type == "ReduceLROnPlateau":
                    scheduler.step(val[metric_key])
                out["loss_val_best"] = min(out["loss_val_best"], val[metric_key])
            t_end = time.perf_counter()
            ph["log"], ph["aux"] = t_aux - t_log, t_end - t_aux
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
    return out


def _event_ms(events) -> list:
    """Milliseconds between each (start, end) pair of CUDA events, once the
    last end has been reached."""
    events[-1][1].synchronize()
    return [float(s.elapsed_time(e)) for s, e in events]
