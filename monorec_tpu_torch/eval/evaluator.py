"""The evaluation loop (``monorec_tpu/eval/evaluator.py``).

Per batch: the eval forward under ``torch.no_grad``, optional per-sample
median scaling, and the metrics on the model's device, then one copy of the
metric vector to the host. A batch with any NaN metric is zeroed and not
counted; ``metrics`` divides each total by its valid batches, and
``metrics_correct`` is the running sample-weighted mean over every batch
(the zeroed ones included), as in the JAX package.

Data parallel (``parallel``): each rank forwards its rows of every global
batch (the loader reads only those) and median-scales them, then the
metrics' inputs are gathered and every rank computes the metrics of the
global batch, so ``metrics``, ``metrics_correct``, ``valid_batches`` and
``num_samples`` are those of one process over the whole batch. A batch the
ranks do not divide is forwarded whole on every rank. Only rank 0 writes
the results.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from monorec_tpu_torch import parallel
from monorec_tpu_torch.metrics import METRIC_INPUTS
from monorec_tpu_torch.utils import median_scaling

logger = logging.getLogger(__name__)


class Evaluator:
    """Evaluates ``model`` over ``data_loader`` with ``metric_fns``; the
    ``evaluater`` block of ``config`` sets ``roi``, ``max_distance``,
    ``median_scaling`` and ``log_step``."""

    def __init__(self, model: torch.nn.Module, metric_fns: Sequence[Callable], config: Dict,
                 data_loader, run_dir="saved/eval"):
        self.model = model
        self.metric_fns = list(metric_fns)
        self.data_loader = data_loader
        ecfg = config.get("evaluater", {})
        self.roi = ecfg.get("roi")
        self.max_distance = ecfg.get("max_distance")
        self.use_median_scaling = ecfg.get("median_scaling", False)
        self.log_step = ecfg.get("log_step", 10)
        self.run_dir = Path(run_dir)
        if parallel.is_main():
            self.run_dir.mkdir(parents=True, exist_ok=True)

    @torch.no_grad()
    def step(self, batch: Dict[str, torch.Tensor], sharded: bool = False) -> torch.Tensor:
        """The metric vector of one batch, on the model's device; with
        ``sharded``, ``batch`` is this rank's rows and the metrics are the
        global batch's."""
        data = {**batch, **self.model(batch)}
        if self.use_median_scaling:
            data["result"] = median_scaling(data["result"], data["target"])
        with parallel.batch_scope(sharded):
            data = parallel.gather_rows(data, METRIC_INPUTS)
        return torch.stack([m(data, self.roi, self.max_distance) for m in self.metric_fns])

    def eval(self) -> Dict:
        self.model.eval()
        n_metrics = len(self.metric_fns)
        total = np.zeros(n_metrics)
        valid = np.zeros(n_metrics)
        running = np.zeros(n_metrics)
        num_samples = 0
        for batch_idx, batch in enumerate(self.data_loader):
            batch, sharded = parallel.loader_batch(self.data_loader, batch)
            metrics = self.step(batch, sharded).cpu().numpy()
            if np.any(np.isnan(metrics)):
                metrics = np.zeros(n_metrics)
            else:
                valid += 1
            total += metrics
            bs = batch["target"].shape[0] * (parallel.world_size() if sharded else 1)
            if num_samples == 0:
                running += metrics
            else:
                running = (running * (num_samples / (num_samples + bs))
                           + metrics * (bs / (num_samples + bs)))
            num_samples += bs
            if batch_idx % self.log_step == 0:
                logger.debug("Evaluating [%d/%d] metrics: %s", batch_idx, len(self.data_loader),
                             list(total / max(batch_idx + 1, 1)))
        log = {
            "metrics": (total / np.maximum(valid, 1)).tolist(),
            "metrics_correct": running.tolist(),
            "valid_batches": float(valid[0]) if n_metrics else 0.0,
            "num_samples": num_samples,
        }
        for i, m in enumerate(self.metric_fns):
            log[m.__name__] = log["metrics"][i]
        return log

    def save_results(self, log: Dict, extra: Optional[Dict] = None,
                     name: str = "results.json") -> Path:
        payload = {"metrics": log}
        if extra:
            payload.update(extra)
        with open(self.run_dir / name, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return self.run_dir / name
