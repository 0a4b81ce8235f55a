"""Ranks, their process group, and the batch rows each rank holds: the
port's counterpart of ``monorec_tpu/parallel/mesh.py``, the replacement for
the reference's ``torch.nn.DataParallel`` (``base/base_trainer.py:26-29``).

One process per card. ``launch`` runs a function on every rank: under
``torchrun`` in the process it started (its environment names the rank and
the group); otherwise it spawns one process per rank (``spawn``, never
``fork``), each joined to a group through a ``file://`` store in a fresh
temporary folder, so no port is chosen. A world of one rank runs in this
process without a group: a one-card run is the one-process code, with no
collective. The backend is NCCL on ``cuda``
(rank r on card r, one card per rank) and gloo on ``cpu``. A group that
cannot be set up raises: nothing falls back to another backend or to fewer
ranks. A rank that raises fails the launch, and ``torch.multiprocessing``
then ends the other ranks.

Each rank holds the contiguous rows ``[r B/W, (r+1) B/W)`` of a global
batch of B, as ``NamedSharding(P("data"))`` lays them out. A batch that W
does not divide is replicated: every rank holds all of it, with one warning
per process, and the step's math is unchanged (``shard_rows``).

While a batch is in flight, ``batch_scope`` records whether the rows a rank
holds are a shard of it. Reductions that couple samples
(``collectives.py``) and random draws of one value per sample
(``draw_rows``) read that to act on the global batch.
Outside a scope, and in a process without a group, everything is local:
one process computes exactly what it computed before.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# torchrun's environment: a process it started joins the group it names.
_TORCHRUN_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_sharded: contextvars.ContextVar[bool] = contextvars.ContextVar("monorec_sharded", default=False)
_warned_replicated = False


def is_active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def is_main() -> bool:
    """Rank 0, the only one that writes logs, images, checkpoints and
    results (and a process without a group)."""
    return rank() == 0


def barrier() -> None:
    if is_active():
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (picklable objects)."""
    if not is_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ----- the rows of a global batch --------------------------------------------


def shard_rows(n: int) -> Tuple[slice, bool]:
    """This rank's rows of a global batch of ``n`` and whether they are a
    shard: ``[r n/W, (r+1) n/W)`` when W divides ``n``, else every row (the
    batch is replicated, with one warning per process)."""
    w = world_size()
    if n % w == 0:
        r = rank()
        return slice(r * n // w, (r + 1) * n // w), is_active()
    global _warned_replicated
    if not _warned_replicated:
        _warned_replicated = True
        logger.warning("shard_batch: a batch of %d is not divisible by the %d ranks; "
                       "replicating instead of sharding (data parallelism disabled for such "
                       "batches).", n, w)
    return slice(0, n), False


def shard_batch(batch: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
    """(this rank's rows of every batched tensor of a global ``batch``,
    whether they are a shard); tensors without a batch dim are kept whole.
    Without a group, ``batch`` itself."""
    if not is_active():
        return batch, False
    sizes = {t.shape[0] for t in batch.values() if torch.is_tensor(t) and t.dim() > 0}
    if len(sizes) != 1:
        raise ValueError(f"shard_batch: the batch's tensors disagree on its size: {sizes}")
    rows, sharded = shard_rows(sizes.pop())
    return {k: t[rows] if torch.is_tensor(t) and t.dim() > 0 else t
            for k, t in batch.items()}, sharded


def loader_batch(loader, batch: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
    """``batch`` as ``loader`` yielded it -> (this rank's rows, whether
    they are a shard). The port's ``DataLoader`` reads only this rank's rows
    and says so in ``loader.sharded``. Without a group any iterable will do
    (its batches are whole); within one a loader that does not say whether
    its batch is a shard is refused, as cutting it again would be wrong."""
    if not is_active():
        return batch, False
    sharded = getattr(loader, "sharded", None)
    if sharded is None:
        raise TypeError(f"{type(loader).__name__} does not say whether its batches are this "
                        "rank's shard (a `sharded` attribute, as the port's DataLoader has)")
    return batch, sharded


@contextlib.contextmanager
def batch_scope(sharded: bool) -> Iterator[None]:
    """Within: the batch in flight is sharded over the group when
    ``sharded`` (and a group is active), else local to this rank."""
    token = _sharded.set(bool(sharded) and is_active())
    try:
        yield
    finally:
        _sharded.reset(token)


def sharded() -> bool:
    """Whether the batch in flight is sharded over the group."""
    return _sharded.get()


def global_rows(n_local: int) -> int:
    """The global batch size of a batch whose rank holds ``n_local`` rows:
    a random draw of one value per sample draws this many, so every rank's
    generator stays in step with the one-process run."""
    return n_local * world_size() if sharded() else n_local


def local_rows(x):
    """This rank's rows of ``x`` drawn for the global batch (a tensor, or a
    NamedTuple of tensors, with the batch leading)."""
    if not sharded():
        return x
    if isinstance(x, tuple):
        return type(x)(*(local_rows(t) for t in x))
    n = x.shape[0] // world_size()
    return x[rank() * n : (rank() + 1) * n]


def draw_rows(draw: Callable[[int], Any], n_local: int) -> Any:
    """``draw(n)`` of a random draw of one value per sample, made for the
    global batch (``global_rows``) and cut to this rank's rows
    (``local_rows``): every rank's generator advances as one process's."""
    return local_rows(draw(global_rows(n_local)))


# ----- launching ranks -------------------------------------------------------


def default_world_size(device) -> int:
    """Every visible card for ``cuda`` (``CUDA_VISIBLE_DEVICES`` narrows
    them), one process for ``cpu`` or a card named by index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.cuda.device_count()
    return 1


def under_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_KEYS)


def _check_world(device: torch.device, n: int) -> None:
    if n < 1:
        raise ValueError(f"the world size must be at least 1, got {n}"
                         + (" (no CUDA device is visible)" if device.type == "cuda" else ""))
    if device.type == "cuda":
        if device.index is not None and n > 1:
            raise ValueError(f"{device} names one card; pass --device cuda for {n} ranks")
        visible = torch.cuda.device_count()
        if n > visible:
            # Two NCCL ranks cannot share a card.
            raise ValueError(f"{n} ranks need {n} cards; {visible} visible")
    elif device.type != "cpu":
        raise ValueError(f"data parallelism runs on cuda or cpu, not {device.type}")


def _run_rank(fn: Callable, args: Sequence, device_type: str, rank_: int, local: int, n: int,
              init_method: str) -> Any:
    """Join the group as ``rank_`` of ``n`` (card ``local`` of its host on
    cuda), run ``fn`` on the rank's device, and leave the group."""
    if device_type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # device_id makes NCCL set up its communicator now, so a failure
        # raises here and not at the first collective.
        dist.init_process_group("nccl", init_method=init_method, rank=rank_, world_size=n,
                                device_id=dev)
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init_method, rank=rank_, world_size=n)
        # The ranks share the host's cores: n processes of as many intra-op
        # threads each as there are cores spin against each other.
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    try:
        return fn(dev, *args)
    finally:
        dist.destroy_process_group()


def _spawned(rank_: int, fn: Callable, args: Sequence, device_type: str, n: int,
             folder: str) -> None:
    result = _run_rank(fn, args, device_type, rank_, rank_, n, f"file://{folder}/store")
    torch.save(result, os.path.join(folder, f"result{rank_}.pt"))


def launch(fn: Callable, world_size_: Optional[int], device, args: Sequence = (),
           group: bool = False) -> List[Any]:
    """Run ``fn(rank_device, *args)`` on every rank and return the ranks'
    results in rank order (under ``torchrun``, this process's only).

    ``world_size_`` None takes ``default_world_size(device)``. Two ranks or
    more join a group (NCCL on ``cuda``, gloo on ``cpu``). One rank runs
    ``fn`` in this process without a group, so a one-card run is the
    one-process code with no collective in it; ``group`` makes that rank
    join a group of one all the same, where every collective of the
    data-parallel path runs (``chip_smoke.py`` drives NCCL so on one card).
    ``fn`` and ``args`` must pickle (a module-level function), and so must
    what ``fn`` returns (keep it on the CPU)."""
    device = torch.device(device)
    if under_torchrun():
        n = int(os.environ["WORLD_SIZE"])
        if world_size_ not in (None, n):
            raise ValueError(f"torchrun started {n} ranks; --world-size says {world_size_}")
        if device.type == "cuda" and device.index is not None:
            raise ValueError(f"under torchrun, pass --device cuda, not {device}")
        return [_run_rank(fn, args, device.type, int(os.environ["RANK"]),
                          int(os.environ["LOCAL_RANK"]), n, "env://")]
    n = default_world_size(device) if world_size_ is None else world_size_
    _check_world(device, n)
    if n == 1 and not group:
        return [fn(device, *args)]
    folder = tempfile.mkdtemp(prefix="monorec-ranks-")
    try:
        if n == 1:
            return [_run_rank(fn, args, device.type, 0, device.index or 0, 1,
                              f"file://{folder}/store")]
        torch.multiprocessing.spawn(_spawned, args=(fn, tuple(args), device.type, n, folder),
                                    nprocs=n, join=True)
        # Each file was written by a rank of this launch.
        return [torch.load(Path(folder) / f"result{r}.pt", weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
