"""The first depth pass under ``simple_mask`` (``models/depth_module.py``,
run without a gradient before the mask reads its finest prediction):
device milliseconds a request of the program's own ``depth_prepass`` span
in ``MonoRec.forward``, from ``record["program"]``. Nothing to read where
a kind records no program spans or the program opens no such span.
Moves ``infer_keyframes_per_s``."""

import statistics

UNIT = "ms"


def read(rec):
    program = rec.get("program") if rec["kind"] == "infer" else None
    span = (program or {}).get("spans", {}).get("depth_prepass")
    return statistics.fmean(span["device_ms"]) if span and span["device_ms"] else None
