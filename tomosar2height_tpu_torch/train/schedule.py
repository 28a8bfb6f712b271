"""Learning-rate schedulers with torch-compatible semantics.

Counterpart of ``tomosar2height_tpu/train/schedule.py`` (pure Python, the
same classes and formulas): CyclicLR, CosineAnnealingLR,
CosineAnnealingWarmRestarts and the metric-driven ReduceLROnPlateau
(reference train.py:97-104). Each is a small host-side object with torch's
``scheduler.step()`` discipline; the trainer sets the optimizer's learning
rate from :attr:`SchedulerBase.lr` at every optimizer step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional


class SchedulerBase:
    def __init__(self, base_lr: float):
        self.base_lr = float(base_lr)
        self.last_step = 0
        self._lr = float(base_lr)

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, metric: Optional[float] = None):
        self.last_step += 1
        self._lr = self._compute_lr(self.last_step, metric)
        return self._lr

    def _compute_lr(self, step: int, metric: Optional[float]) -> float:
        raise NotImplementedError

    def state_dict(self) -> Dict:
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, state: Dict):
        self.__dict__.update(state)


class CyclicLR(SchedulerBase):
    """torch.optim.lr_scheduler.CyclicLR parity (modes triangular/triangular2/
    exp_range); reference config conf/model/tomosar2height.yaml:46-53."""

    def __init__(self, base_lr: float, max_lr: float, step_size_up: int = 2000,
                 step_size_down: Optional[int] = None, mode: str = "triangular",
                 gamma: float = 1.0, cycle_momentum: bool = False, **_):
        super().__init__(base_lr)
        self.max_lr = float(max_lr)
        self.step_size_up = int(step_size_up)
        self.step_size_down = int(step_size_down if step_size_down is not None else step_size_up)
        self.mode = mode
        self.gamma = float(gamma)
        self._lr = self._compute_lr(0, None)

    def _compute_lr(self, step: int, metric=None) -> float:
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + step / total)
        x = 1.0 + step / total - cycle
        ratio = self.step_size_up / total
        if x <= ratio:
            scale = x / ratio
        else:
            scale = (x - 1) / (ratio - 1)
        height = (self.max_lr - self.base_lr) * scale
        if self.mode == "triangular":
            return self.base_lr + height
        if self.mode == "triangular2":
            return self.base_lr + height / (2.0 ** (cycle - 1))
        if self.mode == "exp_range":
            return self.base_lr + height * (self.gamma ** step)
        raise ValueError(f"Unknown CyclicLR mode {self.mode}")


class CosineAnnealingLR(SchedulerBase):
    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0, **_):
        super().__init__(base_lr)
        self.T_max = int(T_max)
        self.eta_min = float(eta_min)

    def _compute_lr(self, step: int, metric=None) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * step / self.T_max)
        ) / 2.0


class CosineAnnealingWarmRestarts(SchedulerBase):
    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0, **_):
        super().__init__(base_lr)
        self.T_0 = int(T_0)
        self.T_mult = int(T_mult)
        self.eta_min = float(eta_min)

    def _compute_lr(self, step: int, metric=None) -> float:
        t_i, t_cur = self.T_0, step
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)
        ) / 2.0


class ReduceLROnPlateau(SchedulerBase):
    """Metric-driven decay; ``step(metric)`` must receive the validation metric
    (torch semantics: only metric steps count)."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, min_lr: float = 0.0, **_):
        super().__init__(base_lr)
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.min_lr = float(min_lr)
        self.best: Optional[float] = None
        self.num_bad = 0

    def _compute_lr(self, step: int, metric: Optional[float]) -> float:
        if metric is None:
            return self._lr
        if self.best is None:
            self.best = metric
            return self._lr
        improved = (
            metric < self.best - self.threshold
            if self.mode == "min"
            else metric > self.best + self.threshold
        )
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self._lr


SCHEDULERS = {
    "CyclicLR": CyclicLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}

# schedulers stepped every iteration (vs metric-driven), reference train.py:188-190
ITERATION_SCHEDULERS = ("CyclicLR", "CosineAnnealingLR", "CosineAnnealingWarmRestarts")


def build_scheduler(cfg_training) -> SchedulerBase:
    s = cfg_training["scheduler"]
    kwargs = dict(s.get("kwargs", {}) or {})
    typ = s["type"]
    base_lr = kwargs.pop("base_lr", cfg_training["learning_rate"])
    kwargs.pop("cycle_momentum", None)
    return SCHEDULERS[typ](base_lr=base_lr, **kwargs)
