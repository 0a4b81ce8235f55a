"""Training logs (``monorec_tpu/train/loggers.py``): ``info.log``, the
``metrics.jsonl`` stream and TensorBoard.

A trainer's run directory gets ``info.log`` (``setup_logging``) and, under
``tb/``, ``metrics.jsonl``: one ``{"step", "tag", "value"}`` object per
scalar, always written, with the tag suffixed by the writer's mode
(``loss/train``, ``abs_rel_sparse_metric/valid``) and a ``steps_per_sec``
scalar whenever the train step advances. TensorBoard event files go beside
it when ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package, which is optional); images go to TensorBoard only. ``read_scalars``
reads the stream back.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np

PACKAGE_LOGGER = "monorec_tpu_torch"


def setup_logging(log_dir, name: str = PACKAGE_LOGGER, verbosity: int = 2) -> logging.Logger:
    """The logger ``name`` (by default the package's, so every module of the
    port logs through it) at ``verbosity`` (0 warning, 1 info, 2 debug),
    writing to ``<log_dir>/info.log``. A later call moves the file to its
    own ``log_dir``. The console is the root logger's: the CLIs configure
    it, and records propagate there."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel({0: logging.WARNING, 1: logging.INFO}.get(verbosity, logging.DEBUG))
    for handler in [h for h in logger.handlers if getattr(h, "_run_log", False)]:
        logger.removeHandler(handler)
        handler.close()
    fh = logging.handlers.RotatingFileHandler(log_dir / "info.log", maxBytes=10 * 1024 * 1024,
                                              backupCount=20)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    fh._run_log = True
    logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Scalar and image sink: ``metrics.jsonl`` always, TensorBoard when
    ``enable_tensorboard`` and the ``tensorboard`` package is installed."""

    def __init__(self, log_dir, enable_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.step = 0
        self.mode = ""
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: metrics.jsonl only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.log_dir))
        self._timer = time.monotonic()

    @property
    def tensorboard(self) -> bool:
        """Whether TensorBoard event files are written."""
        return self._tb is not None

    def set_step(self, step: int, mode: str = "train") -> None:
        if mode == "train" and step > self.step:
            now = time.monotonic()
            dt = now - self._timer
            self._timer = now
            if dt > 0:
                self.add_scalar("steps_per_sec", (step - self.step) / dt)
        self.step = step
        self.mode = mode

    def _tag(self, tag: str) -> str:
        return f"{tag}/{self.mode}" if self.mode else tag

    def add_scalar(self, tag: str, value) -> None:
        value = float(np.asarray(value))
        self._jsonl.write(json.dumps({"step": self.step, "tag": self._tag(tag), "value": value})
                          + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(self._tag(tag), value, self.step)

    def add_image(self, tag: str, image_hwc: np.ndarray) -> None:
        """``image_hwc`` in [0, 1]."""
        if self._tb is not None:
            self._tb.add_image(self._tag(tag), np.asarray(image_hwc), self.step,
                               dataformats="HWC")

    def flush(self) -> None:
        """Write TensorBoard's pending events to disk (the JSONL stream is
        flushed at every scalar)."""
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_grid(images: np.ndarray, nrow: int = 2, normalize: bool = True) -> np.ndarray:
    """(N, H, W, C) -> one HWC grid image in [0, 1]."""
    n, h, w, c = images.shape
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-8)
    rows = -(-n // nrow)
    grid = np.zeros((rows * h, nrow * w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return grid


def read_scalars(path, mode: str = "train") -> Dict[int, Dict[str, float]]:
    """The scalars of one mode in a ``metrics.jsonl`` file, by step:
    ``{step: {tag without "/<mode>": value}}``; a tag written twice at one
    step keeps its last value."""
    suffix = f"/{mode}"
    out: Dict[int, Dict[str, float]] = defaultdict(dict)
    for line in Path(path).read_text().splitlines():
        record = json.loads(line)
        if record["tag"].endswith(suffix):
            out[record["step"]][record["tag"][: -len(suffix)]] = record["value"]
    return dict(out)
