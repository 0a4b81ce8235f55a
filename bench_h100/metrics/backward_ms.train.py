"""Backward and optimizer (autograd, cuDNN, the gradient all-reduce on
several cards, ``train/state.py``): device milliseconds a step on the
stream, from a CUDA event after ``optimizer.zero_grad`` (which precedes the
backward in ``Trainer.train_step``) to one after ``optimizer.step``.
Moves ``train_keyframes_per_s``."""

import statistics

UNIT = "ms"


def read(rec):
    ms = rec["spans"].get("backward") if rec["kind"] == "train" else None
    return statistics.fmean(ms) if ms else None
