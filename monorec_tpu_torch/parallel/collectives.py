"""The collectives of data parallelism: the global batch's reductions in
the losses, the gathered metric inputs, and the gradient all-reduce.

THE GRADIENT RULE. A reduction that couples samples (a masked mean, a batch
mean, a count) is taken over the global batch by ``global_sum``: every rank
sums its rows, the partial sums are all-reduced, and the loss is computed
from the totals, so its value is the global loss on every rank. In the
backward ``global_sum`` is the identity: rank r's gradient is the global
loss's derivative through r's own rows only, and the SUM of the ranks'
gradients (``reduce_gradients``) is the gradient of the global loss. (The
deprecated ``torch.distributed.nn.functional.all_reduce`` all-reduces the
cotangent as well, which multiplies every gradient by W.) A replicated
batch holds the same rows on every rank, computes local reductions and
identical gradients, and those are AVERAGED.

Outside a sharded ``batch_scope`` every function here is the plain local
reduction, unchanged from the one-process code.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch
import torch.distributed as dist

from monorec_tpu_torch.parallel.mesh import is_active, sharded, world_size
from monorec_tpu_torch.tracing import traced

Tensor = torch.Tensor


class _SumOverRanks(torch.autograd.Function):
    """All-reduce SUM in the forward, the identity in the backward."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        total = x.clone()
        dist.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        return grad


def global_sum(x: Tensor) -> Tensor:
    """``x`` summed over the ranks when the batch is sharded, else ``x``;
    differentiable by the rule above."""
    if not sharded():
        return x
    if x.requires_grad:
        return _SumOverRanks.apply(x)
    total = x.clone()
    dist.all_reduce(total)
    return total


def ratio_of_sums(numerator: Tensor, denominator: Tensor) -> Tensor:
    """``numerator / denominator`` of two partial sums, each summed over
    the ranks first when the batch is sharded (one all-reduce for both)."""
    if not sharded():
        return numerator / denominator
    dtype = torch.promote_types(numerator.dtype, denominator.dtype)
    num, den = global_sum(torch.stack([numerator.to(dtype), denominator.to(dtype)])).unbind()
    return num / den


def batch_mean(x: Tensor) -> Tensor:
    """``x.mean()`` over every element of the global batch. The count is
    the host's (every shard holds ``x.numel()``), so nothing is copied to
    the device and the stream never waits on the host."""
    if not sharded():
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * world_size())


def gather_rows(data: Dict[str, Tensor], keys: Iterable[str]) -> Dict[str, Tensor]:
    """The global batch of each of ``keys`` in ``data`` (those it holds),
    its ranks' rows concatenated in rank order, when the batch is sharded;
    else those entries as they are."""
    out = {k: data[k] for k in keys if k in data}
    if not sharded():
        return out
    w = world_size()
    for k, t in out.items():
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(w)]
        dist.all_gather(parts, t)
        out[k] = torch.cat(parts)
    return out


@traced("grad_reduce")
def reduce_gradients(params: Sequence[torch.nn.Parameter], was_sharded: bool) -> None:
    """The global gradient on every rank: the ranks' ``.grad`` summed when
    the batch was sharded, averaged when it was replicated. One all-reduce
    of every gradient, flattened per dtype. Parameters without a gradient
    are left out; the ranks run one graph, so they leave out the same ones."""
    if not is_active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in dict.fromkeys(g.dtype for g in grads):  # the same order on every rank
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        if not was_sharded:
            flat /= world_size()
        offset = 0
        for g in group:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if not is_active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
