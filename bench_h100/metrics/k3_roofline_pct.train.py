"""Kernel K3 (``photo_error.cu``, forward and backward): the frozen bound
of the traced launches (``flops.k3_bound_s`` at each launch's M, from the
program's ``launches_by_batch`` counters, and the cell's H, W) over their
device time in the profiler's trace, in percent. Moves
``train_keyframes_per_s``."""

from bench_h100 import flops

UNIT = "%"


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train" or not trace:
        return None
    s = rec["shape"]
    bound = sum(n * flops.k3_bound_s(kind, int(m), s["height"], s["width"])
                for kind, key in (("fwd", "k3_fwd"), ("bwd", "k3_bwd"))
                for m, n in trace["counters"].get(key, {}).items())
    seconds = sum(t for name, t in trace["kernels"].items()
                  if "photo_error_fwd_kernel" in name or "photo_error_bwd_kernel" in name)
    if bound <= 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
