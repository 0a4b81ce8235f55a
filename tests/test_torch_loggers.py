"""The port's training logs (``monorec_tpu_torch/train/loggers.py``) against
the JAX package's (``monorec_tpu/train/loggers.py``): the same
``set_step`` / ``add_scalar`` sequence gives the same ``metrics.jsonl``
stream of (step, tag) with equal values (``steps_per_sec`` is a wall-clock
rate, so only its place in the stream is compared), and ``make_grid`` is
bit-equal. ``read_scalars``, the missing ``tensorboard`` package and the
run's ``info.log`` are the port's own."""

import json
import logging
import sys

import numpy as np
import pytest

from monorec_tpu.train import loggers as j_loggers
from monorec_tpu_torch.train import loggers

# (mode, step, [(tag, value)]): a train epoch, its validation, the next epoch.
SEQUENCE = [
    ("train", 0, [("loss", 1.25), ("loss_loss", 1.25), ("loss_sdl_0", np.float32(0.5))]),
    ("train", 1, [("loss", 0.75), ("cv_module_time", 12.5)]),
    ("train", 3, [("loss", 0.5)]),
    ("valid", 0, []),
    ("valid", 1, [("loss", 0.625), ("abs_rel_sparse_metric", np.float64(0.125))]),
    ("train", 4, [("loss", 0.25)]),
]


def _drive(writer):
    for mode, step, scalars in SEQUENCE:
        writer.set_step(step, mode)
        for tag, value in scalars:
            writer.add_scalar(tag, value)
    writer.close()


def _records(path):
    return [json.loads(s) for s in path.read_text().splitlines()]


def test_metrics_stream_matches_jax(tmp_path):
    _drive(j_loggers.MetricsWriter(tmp_path / "jax", enable_tensorboard=False))
    _drive(loggers.MetricsWriter(tmp_path / "port", enable_tensorboard=False))
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    got = _records(tmp_path / "port" / "metrics.jsonl")
    assert [(r["step"], r["tag"]) for r in got] == [(r["step"], r["tag"]) for r in want]
    rates = [r for r in got if r["tag"].startswith("steps_per_sec/")]
    assert [r["value"] for r in got if r not in rates] == [
        r["value"] for r in want if not r["tag"].startswith("steps_per_sec/")]
    # As in the JAX writer, the rate of the first train step after a
    # validation is written before the mode changes back, under "valid".
    assert [r["tag"] for r in rates] == ["steps_per_sec/train"] * 2 + ["steps_per_sec/valid"]
    assert all(r["value"] > 0 for r in rates)


def test_read_scalars_groups_the_stream_by_step(tmp_path):
    _drive(loggers.MetricsWriter(tmp_path, enable_tensorboard=False))
    train = loggers.read_scalars(tmp_path / "metrics.jsonl")
    # A step's rate is written when the next step is set, at the step it ends.
    assert sorted(train) == [0, 1, 3, 4]
    rate = train[0].pop("steps_per_sec")
    assert rate > 0 and train[0] == {"loss": 1.25, "loss_loss": 1.25, "loss_sdl_0": 0.5}
    assert set(train[1]) == {"steps_per_sec", "loss", "cv_module_time"}
    assert train[3] == {"loss": 0.5} and train[4] == {"loss": 0.25}
    valid = loggers.read_scalars(tmp_path / "metrics.jsonl", "valid")
    assert sorted(valid) == [1] and valid[1].pop("steps_per_sec") > 0
    assert valid[1] == {"loss": 0.625, "abs_rel_sparse_metric": 0.125}


def test_writer_without_the_tensorboard_package(tmp_path, monkeypatch):
    """A missing ``tensorboard`` package leaves the JSONL stream alone; an
    image then goes nowhere."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = loggers.MetricsWriter(tmp_path, enable_tensorboard=True)
    assert not writer.tensorboard
    writer.add_scalar("loss", 2.0)
    writer.add_image("input", np.zeros((4, 4, 3), np.float32))
    writer.flush()
    writer.close()
    assert _records(tmp_path / "metrics.jsonl") == [{"step": 0, "tag": "loss", "value": 2.0}]
    assert [p.name for p in tmp_path.iterdir()] == ["metrics.jsonl"]


@pytest.mark.parametrize("n,nrow,normalize", [(5, 2, True), (4, 2, False), (7, 3, True),
                                              (1, 2, True)])
def test_make_grid_is_bit_equal(n, nrow, normalize):
    images = np.random.default_rng(n).normal(size=(n, 6, 9, 3)).astype(np.float32)
    want = j_loggers.make_grid(images.copy(), nrow, normalize)
    got = loggers.make_grid(images.copy(), nrow, normalize)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_setup_logging_moves_info_log_to_the_newest_run(tmp_path):
    name = "monorec_tpu_torch.test_loggers"
    try:
        first = loggers.setup_logging(tmp_path / "a", name=name, verbosity=1)
        first.debug("hidden at verbosity 1")
        first.info("first run")
        second = loggers.setup_logging(tmp_path / "b", name=name, verbosity=2)
        second.debug("second run")
        assert second is first and len(second.handlers) == 1
        assert "first run" in (tmp_path / "a" / "info.log").read_text()
        assert "hidden" not in (tmp_path / "a" / "info.log").read_text()
        assert "second run" not in (tmp_path / "a" / "info.log").read_text()
        assert "second run" in (tmp_path / "b" / "info.log").read_text()
    finally:
        logger = logging.getLogger(name)
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()
