"""Data parallel (``parallel/collectives.py``, NCCL): device milliseconds a
step of rank 0's NCCL kernels in the traced steps: the losses' all-reduced
sums, the metric inputs' all-gather and the gradient all-reduce (a
broadcast is the harness's own, which closes the window, and is left out).
Nothing to read on one card. Moves ``train_keyframes_per_s``."""

UNIT = "ms"


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train" or not trace or not trace["items"]:
        return None
    seconds = sum(t for name, t in trace["kernels"].items()
                  if "nccl" in name.lower() and "broadcast" not in name.lower())
    return 1e3 * seconds / trace["items"] if seconds > 0 else None
