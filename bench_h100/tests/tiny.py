"""Tiny cells for the CPU tests: each cell at 32x64, 8 hypotheses, batches
of 2 rows a rank, on at most two ranks."""

TINY = dict(height=32, width=64, depth_steps=8)


def tiny_cell(name: str, **traffic):
    """The cell ``name`` at a tiny size, on at most two ranks."""
    from bench_h100 import harness

    cell = harness.Cell.load(name, TINY)
    tr = cell.traffic
    if "global_batch" in tr:
        cell.chips = min(cell.chips, 2)
        tr.update(global_batch=2 * cell.chips, pool=4, warmup_steps=4, trace_items=2)
    else:
        tr.update(batch=2, pool=3, warmup_requests=1, compared_requests=2,
                  trace_items=2)
    tr.update(traffic)
    return cell


def run_tiny(cell, seed: int = 2**31 + 77, trace: bool = False, faults=()):
    import time

    import torch

    from bench_h100 import harness

    ctx = harness.Context(cell, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                          tuple(faults))
    return ctx, harness.run_cell(ctx)
