"""Training: the trainer (loss, accumulation, AdamW), LR schedulers, the loop."""

from tomosar2height_tpu_torch.train.loop import train
from tomosar2height_tpu_torch.train.schedule import build_scheduler
from tomosar2height_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer", "build_scheduler", "train"]
