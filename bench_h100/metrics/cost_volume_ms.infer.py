"""Cost volume (``MonoRec.cost_volume`` -> K1): device milliseconds a
request, from CUDA events around each call of the method (wrapped on the
instance by the harness). Moves ``infer_keyframes_per_s``."""

import statistics

UNIT = "ms"


def read(rec):
    ms = rec["spans"].get("cost_volume") if rec["kind"] == "infer" else None
    return statistics.fmean(ms) if ms else None
