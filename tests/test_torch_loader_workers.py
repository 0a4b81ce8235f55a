"""The port's ``DataLoader`` with ``num_workers`` threads and a prefetch
queue (``monorec_tpu/data/loader.py:123-170``) against samples assembled in
the test's own thread, on the KITTI tree of ``tests/torch_kitti.py``
(60x200 PNGs read at 32x64): the same batches in the same order, worker
errors raised in the consumer with their own type, no thread left alive
after an early exit, the KITTI reader's shared jitter generator taken one
draw at a time, and the configs' ``num_workers`` reaching the loader.

Every wait on a thread has a timeout.
"""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.data import kitti
from monorec_tpu_torch.data.kitti import KittiOdometryDataset
from monorec_tpu_torch.data.loader import DataLoader, collate
from monorec_tpu_torch.data.synthetic import batch_to_torch
from tests import torch_kitti

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
JOIN_S = 30.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return torch_kitti.write_tree(tmp_path_factory.mktemp("kitti"))


def _dataset(tree, jitter: bool, seed: int = 0):
    return KittiOdometryDataset(str(tree), sequences=["07"],
                                target_image_size=torch_kitti.TARGET,
                                depth_folder="image_depth_sparse", return_stereo=True,
                                return_mvobj_mask=1, use_color_augmentation=jitter, seed=seed)


def _in_thread(dataset, batch_size: int, seed: int, epochs: int):
    """The batches of ``epochs`` shuffled epochs, assembled in this thread."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        idx = np.arange(len(dataset))
        rng.shuffle(idx)
        for i in range(len(dataset) // batch_size):
            b = idx[i * batch_size : (i + 1) * batch_size]
            out.append(batch_to_torch(collate([dataset[int(j)] for j in b]), "cpu"))
    return out


def _producers():
    return [t for t in threading.enumerate() if t.name == "DataLoader-producer"]


def _assert_no_producer():
    for t in _producers():
        t.join(JOIN_S)
    assert not _producers()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def plain_batches(tree):
    return _in_thread(_dataset(tree, False), 4, 5, 2)


@pytest.mark.parametrize("num_workers", [1, 4])
def test_batches_and_order_match_in_thread(tree, plain_batches, num_workers):
    """Two shuffled epochs, without augmentation, the same as in-thread."""
    loader = DataLoader(_dataset(tree, False), 4, seed=5, num_workers=num_workers)
    assert loader.num_workers == num_workers
    _assert_batches_equal([b for _ in range(2) for b in loader], plain_batches)
    _assert_no_producer()


def test_one_worker_with_jitter_matches_in_thread(tree):
    """With colour augmentation one worker draws the jitter in the sample
    order, as the in-thread assembly does."""
    loader = DataLoader(_dataset(tree, True, seed=3), 4, seed=5, num_workers=1)
    got = list(loader)
    _assert_batches_equal(got, _in_thread(_dataset(tree, True, seed=3), 4, 5, 1))


def test_jitter_draws_stay_whole_under_many_workers(tree, monkeypatch):
    """16 workers on 8 cores, the interpreter switching threads every 1 us,
    four epochs: each sample's jitter is one whole draw of the shared
    generator (a torn draw would mix two samples' values), and no draw is
    lost."""
    drawn, draw = [], kitti.sample_color_jitter

    def record(rng):
        drawn.append(draw(rng))
        return drawn[-1]

    monkeypatch.setattr(kitti, "sample_color_jitter", record)
    dataset = _dataset(tree, True, seed=9)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DataLoader(dataset, 4, shuffle=False, num_workers=16)
        batches = [b for _ in range(4) for b in loader]
    finally:
        sys.setswitchinterval(interval)
    rng = np.random.default_rng(9)
    want = [draw(rng) for _ in range(len(drawn))]
    assert len(drawn) == len(batches) * 4 == 4 * (len(dataset) // 4) * 4
    assert drawn == want
    _assert_no_producer()


class WorkerError(Exception):
    pass


class Failing:
    """Sample 5 raises; the others are small arrays."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 5:
            raise WorkerError(f"sample {i}")
        return {"keyframe": np.full((2, 3, 3), i, np.float32)}


def test_worker_error_reaches_the_consumer():
    loader = DataLoader(Failing(), 2, shuffle=False, num_workers=3)
    seen = []
    with pytest.raises(WorkerError, match="sample 5"):
        for batch in loader:
            seen.append(batch["keyframe"][:, 0, 0, 0].tolist())
    assert seen == [[0.0, 1.0], [2.0, 3.0]]
    _assert_no_producer()


class Slow:
    def __len__(self):
        return 40

    def __getitem__(self, i):
        time.sleep(0.01)
        return {"keyframe": np.full((1, 1, 1), i, np.float32)}


@pytest.mark.parametrize("prefetch", [1, 2])
def test_break_leaves_no_producer(prefetch):
    """A ``break`` (and a trainer's ``len_epoch``) closes the iterator: the
    producer, whose queue is full, stops and is joined."""
    loader = DataLoader(Slow(), 2, shuffle=False, num_workers=2, prefetch=prefetch)
    for i, _ in enumerate(loader):
        if i == 1:
            time.sleep(0.2)  # let the producer fill the queue and block on it
            break
    _assert_no_producer()
    it = iter(loader)
    next(it)
    it.close()
    _assert_no_producer()


@pytest.mark.parametrize("config,want", [("evaluate/eval_monorec.json", 8),
                                         ("train/monorec/monorec_mask.json", 8),
                                         ("train/monorec/monorec_depth.json", 16)])
def test_config_num_workers_reaches_the_loader(tree, config, want):
    with open(CONFIGS / config) as f:
        block = json.load(f)["data_loader"]
    block["args"].update(dataset_dir=str(tree), sequences=list(torch_kitti.SEQUENCES),
                         target_image_size=list(torch_kitti.TARGET), use_index_mask=[],
                         validation_split=0.25)
    loader = config_mod.build_data_loader(block, "cpu")
    assert loader.num_workers == want
    assert loader.split_validation().num_workers == want
    del block["args"]["num_workers"]
    assert config_mod.build_data_loader(block, "cpu").num_workers == 4  # the JAX default
