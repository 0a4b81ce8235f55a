"""Evaluation of the port (``monorec_tpu/eval``)."""

from monorec_tpu_torch.eval.evaluator import Evaluator

__all__ = ["Evaluator"]
