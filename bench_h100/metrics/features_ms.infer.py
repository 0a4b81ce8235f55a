"""Features (``models/resnet.py``, the frozen ResNet encoder): device
milliseconds a request of the program's own ``features`` span
(``MonoRec.features``), from ``record["program"]``, the spans that
``tracing.capture`` recorded over the window's requests. Nothing to read
where a kind records no program spans. Moves ``infer_keyframes_per_s``."""

import statistics

UNIT = "ms"


def read(rec):
    program = rec.get("program") if rec["kind"] == "infer" else None
    span = (program or {}).get("spans", {}).get("features")
    return statistics.fmean(span["device_ms"]) if span and span["device_ms"] else None
