"""Kernel K1 (the sweep's source packing, scoring and frame fusion): the
frozen bound of its launches (``flops.k1_bound_s`` at the cell's B, F, D,
H, W) over their device time in the profiler's trace, in percent. Moves
``infer_keyframes_per_s``."""

from bench_h100 import flops

UNIT = "%"

K1_KERNELS = ("pack_texels", "plane_sweep_kernel", "fuse_frames_kernel")


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "infer" or not trace:
        return None
    launches = trace["counters"].get("k1_launches", 0)
    seconds = sum(s for name, s in trace["kernels"].items()
                  if any(k in name for k in K1_KERNELS))
    if not launches or seconds <= 0:
        return None
    s = rec["shape"]
    bound = flops.k1_bound_s(s["batch"], (s["frames"],), s["depth_steps"], s["height"],
                             s["width"])
    return 100.0 * launches * bound / seconds
