"""The whole step: the frozen operations of the keyframes of the window's
completed steps (``flops.step_flops``) a second, over the float32 peak of
all the cards used (67 TFLOP/s each), in percent. Moves
``train_keyframes_per_s``."""

from bench_h100 import flops

UNIT = "%"


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0:
        return None
    return flops.mfu_pct(rec["flops_per_item"], rec["items"], rec["window_s"], rec["chips"])
