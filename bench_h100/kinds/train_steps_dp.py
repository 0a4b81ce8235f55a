"""Traffic kind ``train_steps_dp``: the training steps of
``kinds/_training.py`` data parallel over ``chips`` cards, one process a
card, launched through the program's ``parallel.launch`` (NCCL; gloo on
the CPU). Each rank reads its own rows of every global batch from the
seed; rank 0's clock closes the window for every rank, read every
``_training.STOP_EVERY`` steps. The parent process
prints the result and, once the ranks have ended, runs the reference on
its first card."""

from __future__ import annotations

from bench_h100 import harness
from bench_h100.kinds import _training

KEYS = _training.TRAFFIC_KEYS


def _rank(device, cell, seed, seconds, trace, t_start, faults, world):
    from monorec_tpu_torch import parallel

    return _training.rank_run(device, cell, seed, seconds, trace, t_start, faults,
                              rank=parallel.rank(), world=world)


def run(ctx: harness.Context) -> harness.Run:
    from monorec_tpu_torch import parallel

    world = ctx.cell.chips
    ranks = parallel.launch(_rank, world, ctx.device.type,
                            (ctx.cell, ctx.seed, ctx.seconds, ctx.trace, ctx.t_start, ctx.faults,
                             world))
    return _training.finish(ctx.cell, ctx.seed, ctx.device, ranks, ranks[0], ctx.trace, world)
