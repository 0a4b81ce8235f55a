"""The losses (``trainer.loss_fn`` -> K2, K3): device milliseconds a step,
from CUDA events around each call (wrapped on the instance by the
harness). Moves ``train_keyframes_per_s``."""

import statistics

UNIT = "ms"


def read(rec):
    ms = rec["spans"].get("loss") if rec["kind"] == "train" else None
    return statistics.fmean(ms) if ms else None
