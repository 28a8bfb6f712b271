"""Training engine: mini-steps with gradient accumulation, AdamW, metrics.

Counterpart of ``tomosar2height_tpu/train/trainer.py`` on one device, eager
PyTorch. The same step semantics:

- inputs: the points (``use_cloud``; f32, or u16 on the u16 wire, which
  the model dequantizes) and, with ``use_image``, the image crop: normalized
  on the f32 wire, raw u8 on the u8 wire, normalized inside the step as
  ``(x - mean) / std`` with the dataset's ``image_norm`` (trainer.py:97-100,
  :164-169);
- loss: the masked per-patch mean L1 of the height raster against the GT nDSM
  (``masked_patch_mean``, trainer.py:71-75, :173-187); invalid (empty) patches
  stay in the batch and weigh 0. With ``use_footprint`` also ``loss_ce``:
  ``weight_ce`` x the masked patch mean of the footprint logits' binary
  cross-entropy against ``dsm > FOOTPRINT_THRESHOLD``, in the logits form
  ``optax.sigmoid_binary_cross_entropy`` computes; else ``loss_ce`` is 0;
- accumulation: the mean of ``optimize_every`` mini-step gradients
  (``optax.MultiSteps``); ``grad_reduction='sum'`` scales it back up by the
  window length (trainer.py:196-197);
- optimizer: ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.01)``, the update optax builds as ``scale_by_adam ->
  add_decayed_weights(0.01) -> scale(-lr)`` (trainer.py:56-68), biases
  decayed too; the learning rate is set at each optimizer step;
  ``utils/torch_port.py`` carries its state to and from optax's;
- metrics: ``[loss, loss_l1, loss_ce, grad_norm, param_norm]`` summed on the
  device over the window (grad_norm of each mini-step's own gradient,
  param_norm of the parameters it ran with), read by the host once per window
  (trainer.py:201-209, :275-292);
- wire: the DSM target is clipped to the wire dtype's range and cast
  (float16 by default, trainer.py:240-246), the loss computes in f32; with
  ``wire_cells='device'`` (the default) no cell ids are sent, the model
  recomputes them from points and mask; ``'host'`` uploads the loader's
  (trainer.py:119-123, :237-238). Every sorted layout's batch (the aligned
  ones of ``fused2`` and ``fused``, the plain sorted one of ``cumsum``)
  uploads as it comes: its tile or per-cell offsets and, on ``'host'``, its
  cells;
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
import torch.nn.functional as F

from tomosar2height_tpu_torch.ops.cuda.conv_kernel import fp32_convs

FOOTPRINT_THRESHOLD = 1e-4  # dsm above it is "building" (trainer.py:34)
METRIC_KEYS = ("loss", "loss_l1", "loss_ce", "grad_norm", "param_norm")
EVAL_KEYS = ("loss", "loss_l1", "loss_ce")
DEVICE_KEYS = ("points", "point_mask", "image", "dsm", "patch_valid", "cell", "cell_offsets")


def masked_patch_mean(per_pixel: torch.Tensor, patch_valid: torch.Tensor) -> torch.Tensor:
    """Mean over pixels per patch, then mean over valid patches."""
    per_patch = per_pixel.reshape(per_pixel.shape[0], -1).mean(dim=1)
    w = patch_valid.to(per_patch.dtype)
    return (per_patch * w).sum() / w.sum().clamp_min(1.0)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element binary cross-entropy on logits, the form of
    ``optax.sigmoid_binary_cross_entropy``: finite for any finite logit."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Trainer:
    """Mini-steps, accumulation and the optimizer for one model on one device.

    Args:
        model: the network (``build_model``), already on its device.
        cfg_training: the ``training`` config node (optimize_every,
            grad_reduction, wire_dsm_dtype, learning_rate).
        use_cloud, use_image: the inputs the model reads (the config's keys);
            the image-only network is not ported.
        use_footprint: the footprint head's BCE loss, weighted by
            ``weight_ce``; the model needs the head.
        image_norm: the u8 image wire's (mean, std) per channel (the
            dataset's ``image_norm``), applied to the u8 crops inside the
            step; None on the f32 wire.
    """

    def __init__(self, model: torch.nn.Module, cfg_training: Dict,
                 use_cloud: bool = True, use_image: bool = False,
                 use_footprint: bool = False, weight_ce: float = 10.0,
                 image_norm=None):
        if not use_cloud:
            raise NotImplementedError("the image-only network is not ported "
                                      "(ROADMAP: alternates)")
        if use_footprint and model.decoder.conv_decoder_footprint is None:
            raise ValueError("use_footprint: the model has no footprint head "
                             "(decoder_pixel_kwargs.use_footprint)")
        self.model = model
        self.use_image = bool(use_image)
        self.use_footprint = bool(use_footprint)
        self.weight_ce = float(weight_ce)
        self.device = next(model.parameters()).device
        self.image_norm = None if image_norm is None else tuple(
            torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)
            for x in image_norm)
        self.optimize_every = int(cfg_training["optimize_every"])
        self.grad_reduction = str(cfg_training.get("grad_reduction", "mean"))
        if self.grad_reduction not in ("mean", "sum"):
            raise ValueError(f"Invalid grad_reduction: {self.grad_reduction}")
        self.wire_dsm_dtype = np.dtype(str(cfg_training.get("wire_dsm_dtype", "float16")))
        self.wire_cells = str(cfg_training.get("wire_cells", "device"))
        if self.wire_cells not in ("device", "host"):
            raise ValueError(f"Invalid wire_cells: {self.wire_cells}")
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
            if k not in batch or (k == "cell" and self.wire_cells == "device"):
                continue  # 'device': the model recomputes the cells
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
        image = batch.get("image") if self.use_image else None
        if image is not None and self.image_norm is not None:
            mean, std = self.image_norm
            image = (image.to(torch.float32) - mean) / std
        pa, pb = self.model(batch["points"], batch["point_mask"], image,
                            batch.get("cell"), batch.get("cell_offsets"),
                            footprint=self.use_footprint)
        dsm = batch["dsm"].float()  # the wire dtype may be f16
        valid = batch["patch_valid"]
        loss_l1 = masked_patch_mean((pa[..., 0] - dsm).abs(), valid)
        if self.use_footprint:
            target = (dsm > FOOTPRINT_THRESHOLD).to(pb.dtype)
            loss_ce = self.weight_ce * masked_patch_mean(sigmoid_bce(pb[..., 0], target), valid)
        else:
            loss_ce = torch.zeros((), dtype=loss_l1.dtype, device=loss_l1.device)
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

    @torch.no_grad()
    def module_norms(self) -> Dict[str, float]:
        """L2 norm of each top-level module's parameters (the flax tree's
        top-level names), reduced on the device and read in one copy
        (trainer.py:294-314)."""
        groups: Dict[str, list] = {}
        for name, p in self.model.named_parameters():
            groups.setdefault(name.split(".")[0], []).append(p)
        vec = torch.stack([global_norm(ps) for ps in groups.values()])
        return dict(zip(groups, vec.cpu().double().tolist()))

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
