"""Traffic kind ``train_steps``: back-to-back optimizer steps of one
trainer on one card (``kinds/_training.py``), each on the next batch of a
seeded pool of pinned host batches of ``global_batch`` rows. The window
counts the keyframes of the steps it completes."""

from __future__ import annotations

from bench_h100 import harness
from bench_h100.kinds import _training

KEYS = _training.TRAFFIC_KEYS


def run(ctx: harness.Context) -> harness.Run:
    r = _training.rank_run(ctx.device, ctx.cell, ctx.seed, ctx.seconds, ctx.trace, ctx.t_start,
                           ctx.faults)
    return _training.finish(ctx.cell, ctx.seed, ctx.device, [r], r, ctx.trace, 1)
