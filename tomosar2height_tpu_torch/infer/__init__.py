"""Inference: sliding-window nDSM generation and its evaluation."""

from tomosar2height_tpu_torch.infer.evaluator import DSMEvaluator, print_statistics  # noqa: F401
from tomosar2height_tpu_torch.infer.generator import DSMGenerator, linear_blend_weight  # noqa: F401
