"""The device during inference: the share of the window's time a request
in which the card has nothing to do, in percent: 1 - the device's busy
seconds a traced request (the profiler's device pass, ``harness.Trace``:
kernels and copies, the host's operators not recorded)
over the window's seconds a request (host clock, untraced). The profiler's
own host work, which lengthens the traced requests, is left out. Moves
``infer_keyframes_per_s``."""

UNIT = "%"


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "infer" or not trace or trace["busy_s"] <= 0 or not rec["steps"]:
        return None
    return 100.0 * (1.0 - (trace["busy_s"] / trace["items"]) / (rec["window_s"] / rec["steps"]))
