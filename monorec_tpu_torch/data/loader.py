"""Batching for the port (``monorec_tpu/data/loader.py``): a deterministic
validation split, seeded per-epoch shuffling, ``collate``, threaded sample
assembly with a prefetch queue, the move to the device, and
``DatasetWrapper``, a start/end/every_nth view of a dataset.

Each epoch starts a producer thread that assembles batches with a pool of
``num_workers`` threads (``pool.map`` over ``dataset.__getitem__``, so a
batch's samples keep their order), collates them into NCHW host tensors,
pinned on CUDA, and puts up to ``prefetch`` of them on a queue. The
consumer, the caller's thread, makes the non-blocking copy to the device on
its own current stream: the producer issues no device copy. Threads overlap
what releases the interpreter lock (zlib, numpy); a reader's Python loops
do not run in parallel.

In a data-parallel run (``parallel``) ``batch_size`` is the global batch.
Every rank draws the same seeded split and permutation, and rank r reads
and decodes only its rows ``[r B/W, (r+1) B/W)`` of each global batch, so
the ranks split the host's decoding between their processes; a batch the
ranks do not divide is read whole on every rank (``parallel.shard_rows``).
``sharded`` tells the consumer which of the two the batch it was last
handed is. A dataset whose samples draw their own random jitter (the
KITTI and TUM mono VO readers' colour augmentation) draws it per process
and in thread order, so such samples differ between world sizes, as they
differ between runs.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from monorec_tpu_torch.data.synthetic import batch_to_host
from monorec_tpu_torch.parallel import shard_rows


class DatasetWrapper:
    """The ``start``, ``end`` and ``every_nth`` view of a dataset
    (``monorec_tpu/data/loader.py::DatasetWrapper``); ``end`` -1 is its
    length."""

    def __init__(self, dataset, start: int = 0, end: int = -1, every_nth: int = 1):
        self.dataset = dataset
        self.start = start
        self.end = len(dataset) if end == -1 else end
        self.every_nth = every_nth

    def __getitem__(self, i: int):
        return self.dataset[i * self.every_nth + self.start]

    def __len__(self) -> int:
        return -(-(self.end - self.start) // self.every_nth)


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


_DONE = object()  # the producer's last item


class DataLoader:
    """Batches of a map-style numpy dataset as NCHW tensors on ``device``.

    The first ``validation_split`` of the indices, shuffled once by a fixed
    seed-0 generator, form the validation set (``split_validation``), as in
    the JAX package; the training indices are reshuffled every epoch from
    ``seed``. The trailing partial batch is dropped by default. Samples are
    assembled by ``max(1, num_workers)`` threads, ``prefetch`` batches
    ahead. An exception raised while assembling a batch is raised again by
    the iterator. Closing the iterator early (``break``, or a trainer's
    ``len_epoch``) stops the producer after the batch it is assembling and
    joins it.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 validation_split: float = 0.0, num_workers: int = 4, drop_last: bool = True,
                 seed: int = 17, prefetch: int = 2, device="cpu",
                 _indices: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.sharded = False  # whether the batch last yielded is this rank's shard
        self._rng = np.random.default_rng(seed)
        n = len(dataset)
        self._val_indices = None
        if _indices is not None:
            self.indices = _indices
        elif validation_split and validation_split > 0:
            n_val = int(validation_split) if validation_split >= 1 else int(n * validation_split)
            order = np.arange(n)
            np.random.RandomState(0).shuffle(order)  # fixed split seed
            self._val_indices, self.indices = order[:n_val], order[n_val:]
        else:
            self.indices = np.arange(n)

    def split_validation(self) -> Optional["DataLoader"]:
        if self._val_indices is None or len(self._val_indices) == 0:
            return None
        return DataLoader(self.dataset, self.batch_size, shuffle=False,
                          num_workers=self.num_workers, drop_last=self.drop_last,
                          prefetch=self.prefetch, device=self.device,
                          _indices=self._val_indices)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return -(-len(self.indices) // self.batch_size)

    def _batch_indices(self) -> List[List[int]]:
        idx = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(idx)
        return [[int(j) for j in idx[i * self.batch_size : (i + 1) * self.batch_size]]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        batches = []
        for b in self._batch_indices():
            rows, sharded = shard_rows(len(b))
            batches.append((b[rows], sharded))
        if not batches:
            return
        pin = self.device.type == "cuda"
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            # Never block for good: the consumer may have gone.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    pass

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b, sharded in batches:
                        if stop.is_set():
                            return
                        put((sharded, batch_to_host(
                            collate(list(pool.map(self.dataset.__getitem__, b))), pin)))
            except BaseException as e:  # raised again in the consumer
                put(e)
            put(_DONE)

        producer = threading.Thread(target=produce, name="DataLoader-producer", daemon=True)
        producer.start()
        try:
            while (item := q.get()) is not _DONE:
                if isinstance(item, BaseException):
                    raise item
                self.sharded, host = item
                yield {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
        finally:
            stop.set()
            producer.join()
