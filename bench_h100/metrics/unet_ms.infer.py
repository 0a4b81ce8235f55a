"""Mask and Depth U-Nets (``MonoRec.mask`` + ``MonoRec.depth``): device
milliseconds a request, from CUDA events around each call. Moves
``infer_keyframes_per_s``."""

import statistics

UNIT = "ms"


def read(rec):
    if rec["kind"] != "infer":
        return None
    mask, depth = rec["spans"].get("mask"), rec["spans"].get("depth")
    if not mask or not depth:
        return None
    return statistics.fmean(m + d for m, d in zip(mask, depth))
