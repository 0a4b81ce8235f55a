"""The whole forward: the frozen operations of the keyframes the window
answered (``flops.step_flops(..., "infer")``) a second, over the card's
float32 peak of 67 TFLOP/s, in percent. Moves ``infer_keyframes_per_s``."""

from bench_h100 import flops

UNIT = "%"


def read(rec):
    if rec["kind"] != "infer" or rec["window_s"] <= 0:
        return None
    return flops.mfu_pct(rec["flops_per_item"], rec["items"], rec["window_s"], rec["chips"])
