"""Stage-1 trainer (``monorec_tpu/train/trainer.py``) on one device.

One step: the train forward (augmentation and dropout drawn from the
trainer's ``torch.Generator``s), the loss, the backward and the optimizer
update, optionally skipped when a gradient is not finite. ``_feed`` (the
forward and the loss) is what a subclass replaces: ``monorec_trainer.py``
runs the stage 2-4 protocol there. Around it the
reference's epoch mechanics: iteration-based epochs (``len_epoch``),
NaN-metric batch invalidation, value faders (``alpha``), a monitored metric
with best tracking and early stopping, and checkpoints every
``save_period`` epochs. Logs go to Python ``logging`` and, one JSON object
per log step, to ``<run_dir>/train_log.jsonl``. TensorBoard and the
per-module timing of the JAX trainer are not ported yet.
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from monorec_tpu_torch.train import checkpoints
from monorec_tpu_torch.utils import ValueFader, operator_on_dict

logger = logging.getLogger(__name__)


def apply_gradients_guarded(optimizer: torch.optim.Optimizer,
                            skip_nonfinite: bool) -> Optional[float]:
    """``optimizer.step()``, optionally skipped when a gradient is not finite.

    The guard reads the GRADIENTS, not the loss: a loss can be NaN through
    detached terms while the gradients stay finite, and such steps apply, as
    the reference's ``backward()`` would. A non-finite gradient would poison
    the optimizer state for good; with the guard the update is skipped
    whole (parameters, moments and step count keep their values). Returns
    None when the guard is off, else 1.0 for a skipped step and 0.0 for an
    applied one (``monorec_tpu/train/trainer.py:32-60``).
    """
    if not skip_nonfinite:
        optimizer.step()
        return None
    grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all().item() if grads else True
    if finite:
        optimizer.step()
    return 0.0 if finite else 1.0


class Trainer:
    """Trains ``model`` with ``loss_fn`` on ``data_loader`` (stage 1)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 metric_fns: Sequence[Callable], optimizer: torch.optim.Optimizer, config: Dict,
                 data_loader, valid_data_loader=None, run_dir="saved/run",
                 options: Sequence[str] = (), generator: Optional[torch.Generator] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.metric_fns = list(metric_fns)
        self.optimizer = optimizer
        self.config = config
        self.data_loader = data_loader
        self.valid_data_loader = valid_data_loader
        self.options = tuple(options)
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        # Draws the size of a feature map (the MaskModule's dropout) come
        # from a generator on the model's device, seeded like ``generator``.
        device = next(model.parameters()).device
        self.device_generator = torch.Generator(device=device).manual_seed(
            self.generator.initial_seed())
        self.optimizer_type = config.get("optimizer", {}).get("type", "Adam")

        tcfg = config.get("trainer", {})
        self.epochs = tcfg.get("epochs", 1)
        self.save_period = tcfg.get("save_period", 1)
        self.len_epoch = tcfg.get("len_epoch") or len(data_loader)
        self.log_step = tcfg.get("log_step", int(math.sqrt(max(1, data_loader.batch_size))))
        self.roi = tcfg.get("roi")
        self.roi_train = tcfg.get("roi_train", self.roi)
        self.alpha = tcfg.get("alpha", None)
        self.max_distance = tcfg.get("max_distance", None)
        self.monitor = tcfg.get("monitor", "off")
        self.early_stop = tcfg.get("early_stop", math.inf)
        self.save_multiple = tcfg.get("save_multiple", False)
        self.skip_nonfinite_updates = tcfg.get("skip_nonfinite_updates", False)
        self.value_faders = {k: ValueFader(v[0], v[1])
                             for k, v in tcfg.get("value_faders", {}).items()}
        for key in ("tensorboard", "module_timing"):
            if tcfg.get(key):
                logger.warning("trainer.%s is not ported yet; ignored", key)

        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.run_dir / "train_log.jsonl"

        if self.monitor == "off":
            self.mnt_mode, self.mnt_best = "off", 0.0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
        self.start_epoch = 1

    # ----- steps -------------------------------------------------------------

    @torch.no_grad()
    def _metrics(self, data: Dict) -> np.ndarray:
        data = dict(data, result=data["result"].detach())
        if not self.metric_fns:
            return np.zeros(0)
        values = torch.stack([m(data, self.roi, self.max_distance) for m in self.metric_fns])
        return values.cpu().numpy().astype(np.float64)

    @staticmethod
    def _to_floats(loss_dict: Dict) -> Dict[str, float]:
        keys = list(loss_dict)
        values = torch.stack([torch.as_tensor(loss_dict[k]).detach().float().reshape(())
                              .to(loss_dict["loss"].device) for k in keys])
        return dict(zip(keys, values.tolist()))

    def _feed(self, batch: Dict, train: bool, alpha: float) -> Tuple[Dict, Dict]:
        """The forward and the loss: (loss dict, data = batch + outputs)."""
        if train:
            out = self.model(batch, train=True, generator=self.generator,
                             dropout_generator=self.device_generator)
        else:
            out = self.model(batch)
        data = {**batch, **out}
        return self.loss_fn(data, alpha, self.roi_train, self.options), data

    def train_step(self, batch: Dict, alpha: float) -> Tuple[Dict[str, float], np.ndarray]:
        """One optimizer step on ``batch``; returns the loss dict as floats
        and the metrics."""
        self.model.train()
        loss_dict, data = self._feed(batch, True, alpha)
        self.optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        skipped = apply_gradients_guarded(self.optimizer, self.skip_nonfinite_updates)
        if "cv_uncovered" in data:
            loss_dict["cv_uncovered"] = data["cv_uncovered"].sum()
        floats = self._to_floats(loss_dict)
        if skipped is not None:
            floats["skipped_nonfinite"] = skipped
        return floats, self._metrics(data)

    @torch.no_grad()
    def valid_step(self, batch: Dict, alpha: float) -> Tuple[Dict[str, float], np.ndarray]:
        self.model.eval()
        loss_dict, data = self._feed(batch, False, alpha)
        return self._to_floats(loss_dict), self._metrics(data)

    # ----- epochs ------------------------------------------------------------

    def _alpha(self, epoch: int) -> float:
        if "alpha" in self.value_faders:
            return float(self.value_faders["alpha"].get_value(epoch))
        return float(self.alpha if self.alpha is not None else 0.5)

    def _metric_names(self) -> List[str]:
        return [m.__name__ for m in self.metric_fns]

    def _log_line(self, record: Dict) -> None:
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _train_epoch(self, epoch: int) -> Dict:
        alpha = self._alpha(epoch)
        total_loss = 0.0
        total_loss_dict: Dict = {}
        total_metrics = np.zeros(len(self.metric_fns))
        total_valid = 0
        it = iter(self.data_loader)
        for batch_idx in range(self.len_epoch):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.data_loader)
                batch = next(it)
            loss_dict, metrics = self.train_step(batch, alpha)
            if np.any(np.isnan(metrics)):
                metrics = np.zeros_like(metrics)
            else:
                total_valid += 1
            total_metrics += metrics
            total_loss += loss_dict["loss"]
            total_loss_dict = operator_on_dict(total_loss_dict, loss_dict, lambda a, b: a + b)
            step = (epoch - 1) * self.len_epoch + batch_idx
            if step % self.log_step == 0:
                logger.debug("Train Epoch %d [%d/%d] Loss: %.6f", epoch, batch_idx,
                             self.len_epoch, loss_dict["loss"])
                self._log_line({"epoch": epoch, "step": step, **loss_dict,
                                **dict(zip(self._metric_names(), metrics.tolist()))})

        log = {"loss": total_loss / self.len_epoch,
               "metrics": (total_metrics / max(total_valid, 1)).tolist()}
        for k, v in total_loss_dict.items():
            log[f"loss_{k}"] = v / self.len_epoch
        if self.valid_data_loader is not None:
            log.update(self._valid_epoch(epoch))
        return log

    def _valid_epoch(self, epoch: int) -> Dict:
        alpha = self._alpha(epoch)
        total_loss, n, total_valid = 0.0, 0, 0
        total_metrics = np.zeros(len(self.metric_fns))
        for batch in self.valid_data_loader:
            loss_dict, metrics = self.valid_step(batch, alpha)
            if np.any(np.isnan(metrics)):
                metrics = np.zeros_like(metrics)
            else:
                total_valid += 1
            total_metrics += metrics
            total_loss += loss_dict["loss"]
            n += 1
        return {"val_loss": total_loss / max(n, 1),
                "val_metrics": (total_metrics / max(total_valid, 1)).tolist()}

    def train(self) -> Dict:
        not_improved = 0
        log: Dict = {}
        for epoch in range(self.start_epoch, self.epochs + 1):
            result = self._train_epoch(epoch)
            log = {"epoch": epoch}
            for key, value in result.items():
                if key == "metrics":
                    log.update(zip(self._metric_names(), value))
                elif key == "val_metrics":
                    log.update(("val_" + k, v) for k, v in zip(self._metric_names(), value))
                else:
                    log[key] = value
            for k, v in log.items():
                logger.info("    %-20s: %s", k, v)

            best = False
            if self.mnt_mode != "off":
                if self.mnt_metric not in log:
                    logger.warning("monitor metric '%s' not found; disabling monitoring",
                                   self.mnt_metric)
                    self.mnt_mode = "off"
                else:
                    value = log[self.mnt_metric]
                    improved = ((self.mnt_mode == "min" and value <= self.mnt_best)
                                or (self.mnt_mode == "max" and value >= self.mnt_best))
                    if improved:
                        self.mnt_best, not_improved, best = value, 0, True
                    else:
                        not_improved += 1
                    if not_improved > self.early_stop:
                        logger.info("No improvement for %s epochs; stopping.", self.early_stop)
                        break

            if epoch % self.save_period == 0:
                name = f"checkpoint-epoch{epoch}.pth" if self.save_multiple else "checkpoint.pth"
                checkpoints.save_checkpoint(
                    self.run_dir / name, self.model, self.optimizer, epoch, self.mnt_best,
                    self.config, keep_copy="model_best.pth" if best else None)
        return log

    def resume(self, checkpoint_path) -> None:
        """Continue from a checkpoint: weights, and the optimizer state when
        the optimizer type is unchanged."""
        payload = checkpoints.load_checkpoint(checkpoint_path)
        self.model.load_state_dict(payload["state_dict"])
        saved = payload.get("config", {}).get("optimizer", {}).get("type")
        if saved is None or saved == self.optimizer_type:
            self.optimizer.load_state_dict(payload["optimizer"])
        else:
            logger.warning("Checkpoint optimizer type '%s' differs from config '%s'; "
                           "optimizer state not restored.", saved, self.optimizer_type)
        self.start_epoch = int(payload["epoch"]) + 1
        self.mnt_best = float(payload["monitor_best"])
        logger.info("Resumed from %s at epoch %d", checkpoint_path, self.start_epoch)
