"""Traffic kind ``infer_closed_loop_arch``: ``infer_closed_loop``'s protocol
for the architecture that the configuration's ``arch`` names.

The protocol is ``infer_closed_loop``'s, unchanged: one client sends its
next request when the last is answered; a request is ``batch`` keyframes
from a seeded pool of pinned host batches, timed on the host from the
submission of its host tensors to its inverse depth and mask being in host
memory, through ``MonoRec.forward`` in eval under ``torch.inference_mode``
(as ``cli/inference_example.py::serve`` calls it); ``warmup_requests``
untimed requests, then the window of ``--seconds``; the answers of
``compared_requests`` requests, each the first to start after a seeded
point of the window, held against the plain reference once the window has
closed and the program's state is freed; the same faults, trace passes,
K1 counter and metric names.

What follows ``arch`` (``resnet_layers``, ``simple_mask``): the program's
model, the reference and its seeded weights (``reference_for``), and the
frozen operations a keyframe (``flops_arch.infer_flops``). Traced, the
window also runs inside ``tracing.capture``, and the program's own spans
of the window's requests are ``record["program"]``.
"""

from __future__ import annotations

import contextlib
import statistics
import time

from bench_h100 import flops_arch, harness, scenes
from bench_h100.kinds.infer_closed_loop import INPUT_KEYS, KEYS, gaps, plan  # noqa: F401
from bench_h100.reference import monorec, monorec_r50_simple

def reference_for(arch):
    """The plain reference of ``arch``: its network's class (called with
    ``depth_steps`` and ``inv_depth_min_max``) and its seeded weights
    (``seeded_state_dict(depth_steps, seed, device)``)."""
    key = int(arch.get("resnet_layers", 18)), bool(arch.get("simple_mask", False))
    if key == (18, False):
        return monorec.MonoRecReference, monorec.seeded_state_dict
    if key == (50, True):
        return monorec_r50_simple.MonoRecR50SimpleReference, monorec_r50_simple.seeded_state_dict
    raise ValueError(f"no plain reference for resnet_layers={key[0]}, simple_mask={key[1]}")


def _program_model(cfg, state, device):
    import torch

    from monorec_tpu_torch.config import build_model_config
    from monorec_tpu_torch.models import MonoRec
    from monorec_tpu_torch.precision import set_precision

    set_precision(cfg["precision"])
    with torch.device(device):
        model = MonoRec(build_model_config(cfg["arch"]), device=device)
    model.load_state_dict(state)
    return model.eval()


def _launches() -> int:
    from monorec_tpu_torch.ops.plane_sweep import plane_sweep_cost_volume

    return plane_sweep_cost_volume.launches


def run(ctx: harness.Context) -> harness.Run:
    import torch

    from monorec_tpu_torch import tracing

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    shape = cfg["shape"]
    b, h, w, f, d = tr["batch"], shape["height"], shape["width"], shape["frames"], \
        shape["depth_steps"]
    dev = ctx.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    _, weights = reference_for(cfg["arch"])
    state = weights(d, scenes.sub_seed(ctx.seed, 0), dev)
    model = _program_model(cfg, state, dev)
    del state
    pool_dev = scenes.make_batches(cfg["scene"], tr["pool"], b, h, w, f, False, ctx.seed, dev)
    pool = [scenes.to_host({k: x[k] for k in INPUT_KEYS}, cuda) for x in pool_dev]
    del pool_dev
    order, points = plan(ctx.seed, tr)

    def out_buffers():
        make = (lambda *s: torch.zeros(*s).pin_memory()) if cuda else torch.zeros
        return make(b, 1, h, w), make(b, 1, h, w)

    shared = out_buffers()
    spare = [out_buffers() for _ in points]
    kept = {}  # position in the window -> the buffers its answer landed in

    def request(i: int, buffers) -> float:
        result_host, mask_host = buffers
        t0 = time.perf_counter()
        batch = {k: v.to(dev, non_blocking=True) for k, v in pool[order[i % len(order)]].items()}
        if "half_batch" in ctx.faults:
            batch = {k: v[: b // 2] for k, v in batch.items()}
        with torch.inference_mode():
            out = model(batch)
        result, mask = out["result"], out["cv_mask"]
        if "answer_altered" in ctx.faults:  # one row of every keyframe 0.01 off
            result = result.clone()
            result[..., :1, :] += 0.01
        result_host[: result.shape[0]].copy_(result, non_blocking=True)
        mask_host[: mask.shape[0]].copy_(mask, non_blocking=True)
        sync()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(tr["warmup_requests"]):
        request(-1, shared)
    spans = harness.Spans(cuda)
    trace = harness.Trace(cuda) if ctx.trace else None
    if ctx.trace:
        for attr in ("cost_volume", "mask", "depth"):
            spans.wrap(model, attr, attr)

    latencies = []
    setup_s = time.perf_counter() - ctx.t_start
    # Traced, the program's spans of the window's requests (item i is
    # request i: each request's ``forward`` span opens an item).
    with (tracing.capture(cuda) if ctx.trace else contextlib.nullcontext()) as recorder:
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < ctx.seconds or len(kept) < len(points):
            i = len(latencies)
            if len(kept) < sum(p * ctx.seconds <= t_end - t0 for p in points):
                kept[i] = spare[len(kept)]
            spans.item = i
            latencies.append(request(i, kept.get(i, shared)))
            t_end = time.perf_counter()
    window_s = t_end - t0
    n = len(latencies)
    record = {"kind": "infer", "items": n * b, "steps": n, "window_s": window_s, "chips": 1,
              "flops_per_item": flops_arch.infer_flops(shape, cfg["arch"]),
              "spans": spans.per_item(), "shape": dict(shape, batch=b),
              "compared_positions": sorted(kept)}
    if recorder is not None:
        record["program"] = recorder.collect(items=n)
    if trace is not None:
        # The profiled requests follow the window: the profiler slows the
        # host, during its run and after it, so nothing timed comes later.
        items = tr["trace_items"]
        launches0 = _launches()
        trace.device_pass(lambda j: request(n + j, shared), items)
        k1_launches = _launches() - launches0
        trace.label_pass(lambda j: request(n + items + j, shared), harness.label_items(items))
        record["trace"] = dict(trace.summary(), counters={"k1_launches": k1_launches})
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del model
    if cuda:
        torch.cuda.empty_cache()
    compared = compare(ctx, kept, order)
    return harness.Run(
        attempted=n, failed=0,
        metrics={"infer_keyframes_per_s": n * b / window_s,
                 "infer_p95_ms": statistics.quantiles(latencies, n=20)[-1],
                 "setup_s": setup_s},
        units={"infer_keyframes_per_s": "keyframes/s", "infer_p95_ms": "ms", "setup_s": "s"},
        record=record, memory_peak_bytes=peak, compared=compared, device_count=1)


def reference_answers(ctx: harness.Context, order, requests, exact: bool = True):
    """The reference's ``result`` and ``cv_mask`` of each of ``requests``
    (positions in the window), on the device, from the seed alone."""
    import torch

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    shape = cfg["shape"]
    b, h, w, f, d = tr["batch"], shape["height"], shape["width"], shape["frames"], \
        shape["depth_steps"]
    dev = ctx.device
    network, weights = reference_for(cfg["arch"])
    ref = network(d, cfg["arch"]["inv_depth_min_max"]).to(dev).eval()
    ref.load_state_dict(weights(d, scenes.sub_seed(ctx.seed, 0), dev))
    pool = scenes.make_batches(cfg["scene"], tr["pool"], b, h, w, f, False, ctx.seed, dev)
    monorec.PRECISION.exact = exact
    with monorec.PRECISION:
        out = {}
        for i in requests:
            batch = pool[order[i % len(order)]]
            rows = []
            for r in range(b):  # a row at a time keeps the plain path's memory small
                rows.append(ref.infer({k: v[r:r + 1] for k, v in batch.items()}))
            out[i] = (torch.cat([x["result"] for x in rows]).cpu(),
                      torch.cat([x["cv_mask"] for x in rows]).cpu())
    del ref, pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(ctx: harness.Context, answers, order):
    refs = reference_answers(ctx, order, list(answers))
    values = gaps(answers, refs)
    return [{"name": k, "value": v, "limit": ctx.cell.limits[k]} for k, v in values.items()]
