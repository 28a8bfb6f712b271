"""Training engine: mini-steps with gradient accumulation, AdamW, metrics.

Counterpart of ``tomosar2height_tpu/train/trainer.py`` on one device, eager
PyTorch. The same step semantics:

- loss: the masked per-patch mean L1 of the height raster against the GT nDSM
  (``masked_patch_mean``, trainer.py:71-75, :173-187); invalid (empty) patches
  stay in the batch and weigh 0. ``loss_ce`` is 0: the footprint head's BCE
  loss comes with training the fusion config (ROADMAP: fusion training);
- accumulation: the mean of ``optimize_every`` mini-step gradients
  (``optax.MultiSteps``); ``grad_reduction='sum'`` scales it back up by the
  window length (trainer.py:196-197);
- optimizer: ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.01)``, the update optax builds as ``scale_by_adam ->
  add_decayed_weights(0.01) -> scale(-lr)`` (trainer.py:56-68), biases
  decayed too; the learning rate is set at each optimizer step;
- metrics: ``[loss, loss_l1, loss_ce, grad_norm, param_norm]`` summed on the
  device over the window (grad_norm of each mini-step's own gradient,
  param_norm of the parameters it ran with), read by the host once per window
  (trainer.py:201-209, :275-292);
- wire: the DSM target is clipped to the wire dtype's range and cast
  (float16 by default, trainer.py:240-246), the loss computes in f32; no
  cell ids are sent, the model recomputes them from points and mask (the
  JAX default ``wire_cells='device'``, trainer.py:237-238);
- precision: every cuDNN convolution of the step, backward included, runs
  in full float32 whatever the caller's TF32 flags, with deterministic
  algorithms only (``fp32_convs(deterministic=True)``): with the port's
  kernels, which add in fixed orders, a step on the card is bit-equal run
  to run, as the JAX reference's is.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tomosar2height_tpu_torch.ops.cuda.conv_kernel import fp32_convs

METRIC_KEYS = ("loss", "loss_l1", "loss_ce", "grad_norm", "param_norm")
EVAL_KEYS = ("loss", "loss_l1", "loss_ce")
DEVICE_KEYS = ("points", "point_mask", "dsm", "patch_valid", "cell_offsets")


def masked_patch_mean(per_pixel: torch.Tensor, patch_valid: torch.Tensor) -> torch.Tensor:
    """Mean over pixels per patch, then mean over valid patches."""
    per_patch = per_pixel.reshape(per_pixel.shape[0], -1).mean(dim=1)
    w = patch_valid.to(per_patch.dtype)
    return (per_patch * w).sum() / w.sum().clamp_min(1.0)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Trainer:
    """Mini-steps, accumulation and the optimizer for one model on one device.

    Args:
        model: the network (``build_model``), already on its device.
        cfg_training: the ``training`` config node (optimize_every,
            grad_reduction, wire_dsm_dtype, learning_rate).
        use_footprint: the footprint head's BCE loss (not ported).
    """

    def __init__(self, model: torch.nn.Module, cfg_training: Dict,
                 use_footprint: bool = False):
        if use_footprint:
            raise NotImplementedError(
                "the footprint head's BCE loss comes with training the fusion "
                "config (ROADMAP: fusion training)")
        if getattr(model, "image_encoder", None) is not None:
            raise NotImplementedError(
                "training the cloud+image fusion network (the image in "
                "prepare_batch) is not ported yet (ROADMAP: fusion training)")
        self.model = model
        self.device = next(model.parameters()).device
        self.optimize_every = int(cfg_training["optimize_every"])
        self.grad_reduction = str(cfg_training.get("grad_reduction", "mean"))
        if self.grad_reduction not in ("mean", "sum"):
            raise ValueError(f"Invalid grad_reduction: {self.grad_reduction}")
        self.wire_dsm_dtype = np.dtype(str(cfg_training.get("wire_dsm_dtype", "float16")))
        if cfg_training.get("wire_cells", "device") != "device":
            raise NotImplementedError("only wire_cells='device' is ported (ROADMAP: wires)")
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.AdamW(
            self.params, lr=float(cfg_training.get("learning_rate", 1e-4)),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
        self._grad_sum = [torch.zeros_like(p) for p in self.params]
        self.metric_acc = torch.zeros(len(METRIC_KEYS), device=self.device)
        self.mini_step = 0
        # host-side window bookkeeping; the metric values stay on the device
        # until a reader of last_avg_loss* asks for the closed window
        self.accumulated_steps = 0
        self._pending_acc: Optional[torch.Tensor] = None
        self._avg_cache: Optional[Dict[str, float]] = None

    # -- batches ------------------------------------------------------------------

    def prepare_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Start the host -> device upload of the arrays the step reads (from
        pinned memory, non-blocking on a CUDA device); names and bounds stay
        on the host. Call it for batch k+1 before stepping batch k."""
        out = {}
        cuda = self.device.type == "cuda"
        for k in DEVICE_KEYS:
            if k not in batch:
                continue
            v = np.asarray(batch[k])
            if k == "dsm" and v.dtype != self.wire_dsm_dtype:
                # clip to the wire dtype's range: garbage targets of invalid
                # patches must not become inf (0 * inf = nan in the loss)
                fi = np.finfo(self.wire_dsm_dtype)
                v = np.clip(v, fi.min, fi.max).astype(self.wire_dsm_dtype)
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(self.device, non_blocking=True) if cuda
                      else t.to(self.device))
        return out

    # -- loss ---------------------------------------------------------------------

    def loss(self, batch: Dict[str, torch.Tensor]):
        """(loss, {'loss', 'loss_l1', 'loss_ce'}) of a prepared batch."""
        pa, _ = self.model(batch["points"], batch["point_mask"], None,
                           batch.get("cell"), batch.get("cell_offsets"))
        dsm = batch["dsm"].float()  # the wire dtype may be f16
        loss_l1 = masked_patch_mean((pa[..., 0] - dsm).abs(), batch["patch_valid"])
        loss_ce = torch.zeros((), device=loss_l1.device)
        loss = loss_l1 + loss_ce
        return loss, {"loss": loss, "loss_l1": loss_l1, "loss_ce": loss_ce}

    # -- steps --------------------------------------------------------------------

    def train_step(self, batch: Dict, lr: float) -> None:
        """One mini-step on a host or prepared batch; every
        ``optimize_every``-th applies the window's gradient with ``lr``.
        Nothing here waits for the device."""
        if not isinstance(batch.get("points"), torch.Tensor):
            batch = self.prepare_batch(batch)
        self.model.train()
        # the conv backwards (dgrad, wgrad) run in this call, outside the
        # layers' own float32 scopes: the step holds one of its own, which
        # also keeps cuDNN to deterministic algorithms (bit-exact steps)
        with fp32_convs(deterministic=True):
            loss, metrics = self.loss(batch)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        with torch.no_grad():
            step_vec = torch.stack([metrics["loss"], metrics["loss_l1"], metrics["loss_ce"],
                                    global_norm(grads), global_norm(self.params)]).float()
            if self.mini_step % self.optimize_every == 0:
                self.metric_acc = step_vec
            else:
                self.metric_acc = self.metric_acc + step_vec
            torch._foreach_add_(self._grad_sum, grads)
        self.mini_step += 1
        self.accumulated_steps += 1
        if self.accumulated_steps == self.optimize_every:
            self._apply(lr)
            self._pending_acc = self.metric_acc
            self._avg_cache = None
            self.accumulated_steps = 0

    def _apply(self, lr: float) -> None:
        scale = 1.0 if self.grad_reduction == "sum" else 1.0 / self.optimize_every
        for p, g in zip(self.params, self._grad_sum):
            p.grad = g * scale
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        for g in self._grad_sum:
            g.zero_()

    # -- window metrics -----------------------------------------------------------

    def _averages(self) -> Dict[str, float]:
        if self._avg_cache is None:
            if self._pending_acc is None:
                self._avg_cache = dict.fromkeys(METRIC_KEYS, 0.0)
            else:
                acc = self._pending_acc.cpu().numpy().astype(np.float64) / self.optimize_every
                self._avg_cache = dict(zip(METRIC_KEYS, acc.tolist()))
        return self._avg_cache

    @property
    def last_avg_loss(self) -> float:
        """Mean loss of the last closed window (reads the device)."""
        return self._averages()["loss"]

    @property
    def last_avg_loss_dict(self) -> Dict[str, float]:
        d = dict(self._averages())
        d.pop("loss")
        return d

    # -- evaluation ---------------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, float]:
        _, metrics = self.loss(self.prepare_batch(batch))
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def evaluate(self, val_loader) -> Dict[str, float]:
        """Validation averages weighted by valid patches, summed on the
        device over the loader and read once at the end."""
        acc = torch.zeros(len(EVAL_KEYS) + 1, device=self.device)
        for batch in val_loader:
            dev = self.prepare_batch(batch)
            _, metrics = self.loss(dev)
            n_valid = dev["patch_valid"].sum().float()
            vec = torch.stack([metrics[k] for k in EVAL_KEYS]).float()
            acc += torch.cat([vec * n_valid, n_valid[None]])
        vals = acc.cpu().numpy().astype(np.float64)
        n = max(float(vals[-1]), 1.0)
        return {k: float(v) / n for k, v in zip(EVAL_KEYS, vals[:-1])}
