"""Weight bridge between a flax parameter tree and the port's ``state_dict``.

Counterpart of ``tomosar2height_tpu/utils/torch_port.py`` without JAX: the
flax tree arrives as nested dicts of numpy arrays (``{'params': {...}}`` or
the inner dict). The port names its modules after the flax modules, so the
state_dict key of a leaf is its flax path joined with dots, with ``kernel``
read as ``weight``. Layout rules (the conversions are pure permutations):

- Dense kernel (in, out) <-> Linear weight (out, in);
- Conv kernel (kh, kw, I, O) <-> Conv2d weight (O, I, kh, kw); the dense-skip
  head ``conv4`` is a (1, 1, 288, 1) conv;
- ConvTranspose kernel (kh, kw, I, O) <-> ConvTranspose2d weight
  (I, O, kh, kw) with a spatial flip (flax applies the kernel mirrored
  relative to torch's transposed convolution; torch_port.py:106-111).

The fused2 and composed paths of the JAX package declare the same tree, so one
bridge serves both.

The optimizer state crosses too (:func:`optimizer_to_optax`,
:func:`load_optax_state`): a :class:`~tomosar2height_tpu_torch.train.Trainer`'s
AdamW state and accumulation window as the state dict of the optax state
that the JAX ``make_optimizer(optimize_every)`` builds (flax
``to_state_dict``: namedtuples and tuples as dicts of their fields and
indices), with every tree laid out as the weights are. Trees come out with
their keys sorted, as JAX's pytree functions leave them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_TRANSPOSE_CONVS = ("upconv", "res_up")


def flatten_tree(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_tree(flat: Dict[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _to_torch_layout(mod_path, leaf_name, w: np.ndarray) -> np.ndarray:
    if leaf_name != "kernel":
        return w
    if w.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return w.T
    if mod_path[-1] in _TRANSPOSE_CONVS:  # ConvTranspose -> (I, O, kh, kw), flipped
        return w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return w.transpose(3, 2, 0, 1)  # Conv (kh, kw, I, O) -> (O, I, kh, kw)


def _to_flax_layout(mod_path, leaf_name, w: np.ndarray) -> np.ndarray:
    if leaf_name != "kernel":
        return w
    if w.ndim == 2:
        return w.T
    if mod_path[-1] in _TRANSPOSE_CONVS:
        return w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return w.transpose(2, 3, 1, 0)


def flax_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's state_dict tensors."""
    tree = params.get("params", params)
    sd = {}
    for path, leaf in flatten_tree(tree).items():
        mod_path, leaf_name = path[:-1], path[-1]
        w = _to_torch_layout(mod_path, leaf_name, np.asarray(leaf))
        key = ".".join(mod_path) + (".weight" if leaf_name == "kernel" else f".{leaf_name}")
        sd[key] = torch.from_numpy(np.array(w, dtype=np.float32))  # a copy
    return sd


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_to_state_dict`: -> {'params': nested numpy}."""
    flat = {}
    for key, t in sd.items():
        parts = key.split(".")
        mod_path, name = tuple(parts[:-1]), parts[-1]
        leaf_name = "kernel" if name == "weight" else name
        w = t.detach().cpu().numpy()
        flat[mod_path + (leaf_name,)] = np.ascontiguousarray(
            _to_flax_layout(mod_path, leaf_name, w))
    return {"params": unflatten_tree(flat)}


def load_flax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a flax param tree into ``model``; every key must match both ways."""
    sd = flax_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing[:8]}, unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} vs model {tuple(own[k].shape)}")
    model.load_state_dict(sd)
    return model


def sort_tree(tree):
    """A copy of a nested dict with every level's keys sorted."""
    if not isinstance(tree, dict):
        return tree
    return {k: sort_tree(tree[k]) for k in sorted(tree)}


def _named_tree(trainer, tensors) -> dict:
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    return sort_tree(state_dict_to_flax(dict(zip(names, tensors))))


def optimizer_to_optax(trainer) -> dict:
    """The state dict of optax's optimizer state for ``trainer``:

    - ``inner_opt_state/0/{count, mu, nu}``: AdamW's ``step``, ``exp_avg`` and
      ``exp_avg_sq`` (``scale_by_adam``); ``/1``, ``/2`` the empty states of
      the weight decay and the sign flip;
    - with ``optimize_every`` > 1 the ``optax.MultiSteps`` fields around it:
      ``mini_step`` (the position in the window), ``gradient_step`` (windows
      applied), ``acc_grads`` (optax's running mean of the window's gradients:
      ``_grad_sum / mini_step``, times the window length under
      ``grad_reduction='sum'``; zeros at a window boundary) and an empty
      ``skip_state``.
    Every leaf is a numpy array (int32 counters)."""
    params = trainer.params
    states = [trainer.optimizer.state.get(p, {}) for p in params]
    count = int(states[0]["step"]) if states and "step" in states[0] else 0
    zeros = [torch.zeros_like(p) for p in params]
    adam = {"count": np.asarray(count, np.int32),
            "mu": _named_tree(trainer, [s.get("exp_avg", z) for s, z in zip(states, zeros)]),
            "nu": _named_tree(trainer, [s.get("exp_avg_sq", z)
                                        for s, z in zip(states, zeros)])}
    inner = {"0": adam, "1": {}, "2": {}}
    k = trainer.optimize_every
    if k == 1:
        return inner
    m = trainer.accumulated_steps
    scale = (k if trainer.grad_reduction == "sum" else 1) / max(m, 1)
    return {"mini_step": np.asarray(m, np.int32), "gradient_step": np.asarray(count, np.int32),
            "inner_opt_state": inner,
            "acc_grads": _named_tree(trainer, [g * scale for g in trainer._grad_sum]),
            "skip_state": {}}


def _leaves_in_param_order(trainer, tree) -> list:
    sd = flax_to_state_dict(tree)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    missing = sorted(set(names) - set(sd))
    if missing:
        raise KeyError(f"optimizer tree lacks {missing[:8]}")
    return [sd[n] for n in names]


def load_optax_state(trainer, tree) -> None:
    """Set ``trainer``'s AdamW state and window from an optax state dict
    (:func:`optimizer_to_optax`'s layout, e.g. read from a JAX checkpoint).
    A count of 0 leaves AdamW's state empty, as a fresh optimizer's."""
    k = trainer.optimize_every
    if k == 1:
        inner, m = tree, 0
    else:
        inner, m = tree["inner_opt_state"], int(tree["mini_step"])
    adam = inner["0"]
    count = int(adam["count"])
    params = trainer.params
    mu, nu = _leaves_in_param_order(trainer, adam["mu"]), _leaves_in_param_order(trainer, adam["nu"])
    for p, a, b in zip(params, mu, nu):
        if tuple(a.shape) != tuple(p.shape) or tuple(b.shape) != tuple(p.shape):
            raise ValueError(f"optimizer state shape {tuple(a.shape)} vs parameter "
                             f"{tuple(p.shape)}")
    trainer.optimizer.state.clear()
    if count:
        for p, a, b in zip(params, mu, nu):
            trainer.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": a.to(device=p.device, dtype=p.dtype),
                "exp_avg_sq": b.to(device=p.device, dtype=p.dtype)}
    with torch.no_grad():
        if m:
            scale = m / (k if trainer.grad_reduction == "sum" else 1)
            acc = _leaves_in_param_order(trainer, tree["acc_grads"])
            for g, a in zip(trainer._grad_sum, acc):
                g.copy_(a.to(g.device) * scale)
        else:
            for g in trainer._grad_sum:
                g.zero_()
    trainer.accumulated_steps = m
    trainer.mini_step = count * k + m
