"""Batching for the port (``monorec_tpu/data/loader.py``): a deterministic
validation split, seeded per-epoch shuffling, ``collate``, the move to the
device, and ``DatasetWrapper``, a start/end/every_nth view of a dataset.
There is no thread pool: samples are assembled in the caller's thread, and
on CUDA each batch goes through pinned memory with a non-blocking copy.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from monorec_tpu_torch.data.synthetic import batch_to_torch


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


class DataLoader:
    """Batches of a map-style numpy dataset as NCHW tensors on ``device``.

    The first ``validation_split`` of the indices, shuffled once by a fixed
    seed-0 generator, form the validation set (``split_validation``), as in
    the JAX package; the training indices are reshuffled every epoch from
    ``seed``. The trailing partial batch is dropped by default.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 validation_split: float = 0.0, drop_last: bool = True, seed: int = 17,
                 device="cpu", _indices: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
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
                          drop_last=self.drop_last, device=self.device,
                          _indices=self._val_indices)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return -(-len(self.indices) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(idx)
        for i in range(len(self)):
            batch = idx[i * self.batch_size : (i + 1) * self.batch_size]
            yield batch_to_torch(collate([self.dataset[int(j)] for j in batch]), self.device)
