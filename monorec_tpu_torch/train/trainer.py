"""Stage-1 trainer (``monorec_tpu/train/trainer.py``), on one device or
data parallel over the ranks of a process group (``parallel``).

One step: the optional colour jitter of the images
(``trainer.color_aug_on_device``), the train forward (augmentation and
dropout drawn from the trainer's ``torch.Generator``s), the loss, the backward and the optimizer
update, optionally skipped when a gradient is not finite. ``_feed`` (the
forward and the loss) is what a subclass replaces: ``monorec_trainer.py``
runs the stage 2-4 protocol there. Around it the
reference's epoch mechanics: iteration-based epochs (``len_epoch``),
NaN-metric batch invalidation, value faders (``alpha``), a monitored metric
with best tracking and early stopping, and checkpoints every
``save_period`` epochs.

Data parallel (one process per card, ``parallel.launch``): every rank
builds the same seed-0 model (then takes rank 0's weights) and its loader
reads only its rows of each global batch. The step runs the forward and
the loss on those rows inside ``parallel.batch_scope``, where every
reduction that couples samples is the global batch's, so each rank's loss
dict is the global one; the gradients are summed over the ranks before the
non-finite guard reads them, so every rank applies (or skips) the same
update. The metrics are computed on the global batch's gathered
``result``, ``target`` and ``mvobj_mask``. ``len_epoch``, ``log_step`` and
``data_loader.batch_size`` count global batches. Only rank 0 writes the
logs, the images (of its own rows) and the checkpoints.

Logs as the JAX trainer's (``train/loggers.py``): ``<run_dir>/info.log``,
and ``<run_dir>/tb/metrics.jsonl`` with ``loss`` and ``loss_<key>`` of every
train step, the validation's ``loss`` and metrics, ``steps_per_sec``, and,
with ``trainer.module_timing``, the cost volume's, encoder's, MaskModule's
and DepthModule's times on log steps (``cv_module_time`` ...,
milliseconds, from the log step's own spans). TensorBoard event files
(``trainer.tensorboard``, on by default) and their images of inputs, outputs and targets on log steps go
beside it where the ``tensorboard`` package is installed.
"""

from __future__ import annotations

import contextlib
import logging
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from monorec_tpu_torch import parallel, tracing
from monorec_tpu_torch.metrics import METRIC_INPUTS
from monorec_tpu_torch.models.augmentation import jitter_image_keys
from monorec_tpu_torch.train import checkpoints
from monorec_tpu_torch.train.loggers import MetricsWriter, make_grid, setup_logging
from monorec_tpu_torch.utils import ValueFader, operator_on_dict

logger = logging.getLogger(__name__)

# The spans a log step's module times read, by the key each is logged under.
MODULE_TIME_SPANS = {"cost_volume": "cv_module_time", "features": "resnet_module_time",
                     "mask": "mask_module_time", "depth": "depth_module_time"}


@tracing.traced("optimizer")
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
    finite = True
    if grads:
        flag = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        with tracing.span("sync.guard"):
            finite = flag.item()
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
        parallel.broadcast_module(model)

        tcfg = config.get("trainer", {})
        self.epochs = tcfg.get("epochs", 1)
        self.save_period = tcfg.get("save_period", 1)
        self.len_epoch = tcfg.get("len_epoch") or len(data_loader)
        self.log_step = tcfg.get("log_step", int(math.sqrt(max(1, data_loader.batch_size))))
        self.val_log_step = tcfg.get("val_step", 1)
        self.roi = tcfg.get("roi")
        self.roi_train = tcfg.get("roi_train", self.roi)
        self.alpha = tcfg.get("alpha", None)
        self.max_distance = tcfg.get("max_distance", None)
        self.monitor = tcfg.get("monitor", "off")
        self.early_stop = tcfg.get("early_stop", math.inf)
        self.save_multiple = tcfg.get("save_multiple", False)
        self.skip_nonfinite_updates = tcfg.get("skip_nonfinite_updates", False)
        # The colour jitter of the images in training steps, on their device
        # (the JAX package's on-device jitter; the dataset's own jitter
        # should then be off).
        self.color_aug_on_device = tcfg.get("color_aug_on_device", False)
        self.value_faders = {k: ValueFader(v[0], v[1])
                             for k, v in tcfg.get("value_faders", {}).items()}
        self.invert_output_images = tcfg.get("invert_output_images", True)
        # Times the submodules on log steps (``_module_times``).
        self.module_timing = tcfg.get("module_timing", False)

        self.run_dir = Path(run_dir)
        if parallel.is_main():
            self.run_dir.mkdir(parents=True, exist_ok=True)
        setup_logging(self.run_dir, verbosity=tcfg.get("verbosity", 2))
        self.writer = MetricsWriter(self.run_dir / "tb",
                                    enable_tensorboard=tcfg.get("tensorboard", True))

        if self.monitor == "off":
            self.mnt_mode, self.mnt_best = "off", 0.0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
        self.start_epoch = 1

    # ----- steps -------------------------------------------------------------

    @torch.no_grad()
    def _metrics(self, data: Dict, sharded: bool = False) -> np.ndarray:
        """The metric vector of the global batch (its inputs gathered from
        the ranks when ``sharded``)."""
        if not self.metric_fns:
            return np.zeros(0)
        with parallel.batch_scope(sharded):
            data = parallel.gather_rows(data, METRIC_INPUTS)
        values = torch.stack([m(data, self.roi, self.max_distance) for m in self.metric_fns])
        with tracing.span("sync.metrics"):
            values = values.cpu()
        return values.numpy().astype(np.float64)

    @staticmethod
    def _to_floats(loss_dict: Dict) -> Dict[str, float]:
        keys = list(loss_dict)
        values = torch.stack([torch.as_tensor(loss_dict[k]).detach().float().reshape(())
                              .to(loss_dict["loss"].device) for k in keys])
        with tracing.span("sync.losses"):
            floats = values.tolist()
        return dict(zip(keys, floats))

    def _jitter(self, batch: Dict, train: bool) -> Dict:
        """``batch`` with its images colour-jittered in training when
        ``color_aug_on_device`` is set, before anything else reads it; the
        draws come from ``generator``."""
        if train and self.color_aug_on_device:
            return jitter_image_keys(batch, self.generator)
        return batch

    @tracing.traced("feed")
    def _feed(self, batch: Dict, train: bool, alpha: float) -> Tuple[Dict, Dict]:
        """The forward and the loss: (loss dict, data = batch + outputs)."""
        batch = self._jitter(batch, train)
        if train:
            out = self.model(batch, train=True, generator=self.generator,
                             dropout_generator=self.device_generator)
        else:
            out = self.model(batch)
        data = {**batch, **out}
        with tracing.span("loss"):
            loss_dict = self.loss_fn(data, alpha, self.roi_train, self.options)
        return loss_dict, data

    @staticmethod
    def _viz(data: Dict) -> Dict:
        """What the image log shows of a step's outputs."""
        mask = data.get("mask")
        return {"result": data["result"].detach(), "mask": None if mask is None else mask.detach()}

    @tracing.traced("train_step")
    def train_step(self, batch: Dict, alpha: float,
                   sharded: bool = False) -> Tuple[Dict[str, float], np.ndarray, Dict]:
        """One optimizer step on ``batch``; returns the loss dict as floats,
        the metrics and the outputs for the image log. ``sharded``: the
        batch is this rank's rows of the global batch (else every rank
        holds all of it)."""
        self.model.train()
        with parallel.batch_scope(sharded):
            loss_dict, data = self._feed(batch, True, alpha)
            if "cv_uncovered" in data:  # the log schema's, always 0 (see MonoRec.forward)
                loss_dict["cv_uncovered"] = loss_dict["loss"].new_zeros(())
        self.optimizer.zero_grad(set_to_none=True)
        with tracing.span("backward"):
            loss_dict["loss"].backward()
        parallel.reduce_gradients([p for g in self.optimizer.param_groups for p in g["params"]],
                                  sharded)
        skipped = apply_gradients_guarded(self.optimizer, self.skip_nonfinite_updates)
        floats = self._to_floats(loss_dict)
        if skipped is not None:
            floats["skipped_nonfinite"] = skipped
        return floats, self._metrics(data, sharded), self._viz(data)

    @torch.no_grad()
    def valid_step(self, batch: Dict, alpha: float,
                   sharded: bool = False) -> Tuple[Dict[str, float], np.ndarray, Dict]:
        self.model.eval()
        with parallel.batch_scope(sharded):
            loss_dict, data = self._feed(batch, False, alpha)
        return self._to_floats(loss_dict), self._metrics(data, sharded), self._viz(data)

    @staticmethod
    def _module_times(spans: Dict) -> Dict[str, float]:
        """Milliseconds of the cost volume, the ResNet encoder, the MaskModule
        and the DepthModule in ``spans``, what one step's ``tracing.capture``
        collected, summed over
        their calls in the step (device time on the card): those the step
        ran, under the keys of ``monorec_tpu/train/trainer.py::_module_times``."""
        return {key: sum(spans["spans"][name]["device_ms"])
                for name, key in MODULE_TIME_SPANS.items() if name in spans["spans"]}

    def _log_images(self, batch: Dict, viz: Dict) -> None:
        """Inputs, outputs (inverse depth shown as depth, beside the mask) and
        targets of up to 8 samples, as TensorBoard images; skipped without
        TensorBoard, the only place they go."""
        if not self.writer.tensorboard:
            return

        def hwc(x):
            return x.detach().float().permute(0, 2, 3, 1).cpu().numpy()

        n = min(batch["keyframe"].shape[0], 8)
        result = hwc(viz["result"][:n])
        if self.invert_output_images:
            result = np.clip(1.0 / np.where(result == 0, np.inf, result), 0, 100)
            result = result / max(result.max() * 2 / 3, 1e-8)
        if viz.get("mask") is not None:
            result = np.concatenate([result, hwc(viz["mask"][:n])], axis=1)
        self.writer.add_image("input", make_grid(hwc(batch["keyframe"][:n]) + 0.5, 2, True))
        self.writer.add_image("output", make_grid(result, 2, True))
        if "target" in batch:
            gt = hwc(batch["target"][:n])
            gt = np.clip(np.where(gt == 0, 0, 1 / np.where(gt == 0, 1, gt)), 0, 100)
            self.writer.add_image("ground_truth", make_grid(gt, 2, True))

    # ----- epochs ------------------------------------------------------------

    def _alpha(self, epoch: int) -> float:
        if "alpha" in self.value_faders:
            return float(self.value_faders["alpha"].get_value(epoch))
        return float(self.alpha if self.alpha is not None else 0.5)

    def _metric_names(self) -> List[str]:
        return [m.__name__ for m in self.metric_fns]

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
            batch, sharded = parallel.loader_batch(self.data_loader, batch)
            step = (epoch - 1) * self.len_epoch + batch_idx
            timed = self.module_timing and step % self.log_step == 0
            cuda = next(self.model.parameters()).is_cuda
            with tracing.capture(cuda) if timed else contextlib.nullcontext() as recorder:
                loss_dict, metrics, viz = self.train_step(batch, alpha, sharded)
            self.writer.set_step(step)
            self.writer.add_scalar("loss", loss_dict["loss"])
            for k, v in loss_dict.items():
                self.writer.add_scalar(f"loss_{k}", v)
            if np.any(np.isnan(metrics)):
                metrics = np.zeros_like(metrics)
            else:
                total_valid += 1
            total_metrics += metrics
            total_loss += loss_dict["loss"]
            total_loss_dict = operator_on_dict(total_loss_dict, loss_dict, lambda a, b: a + b)
            if step % self.log_step == 0:
                extra = ""
                if timed:
                    times = self._module_times(recorder.collect())
                    for k, v in times.items():
                        self.writer.add_scalar(k, v)
                    extra = " " + " ".join(f"{k.removesuffix('_module_time')}={v:.1f}ms"
                                           for k, v in times.items())
                logger.debug("Train Epoch %d [%d/%d] Loss: %.6f%s", epoch, batch_idx,
                             self.len_epoch, loss_dict["loss"], extra)
                self._log_images(batch, viz)

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
        for batch_idx, batch in enumerate(self.valid_data_loader):
            batch, sharded = parallel.loader_batch(self.valid_data_loader, batch)
            loss_dict, metrics, viz = self.valid_step(batch, alpha, sharded)
            if np.any(np.isnan(metrics)):
                metrics = np.zeros_like(metrics)
            else:
                total_valid += 1
            total_metrics += metrics
            total_loss += loss_dict["loss"]
            n += 1
            self.writer.set_step((epoch - 1) * len(self.valid_data_loader) + batch_idx, "valid")
            if batch_idx % self.val_log_step == 0:
                self._log_images(batch, viz)
        n = max(n, 1)
        self.writer.add_scalar("loss", total_loss / n)
        for name, value in zip(self._metric_names(), total_metrics):
            self.writer.add_scalar(name, value / n)
        return {"val_loss": total_loss / n,
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

            self.writer.flush()
            if epoch % self.save_period == 0:
                name = f"checkpoint-epoch{epoch}.pth" if self.save_multiple else "checkpoint.pth"
                checkpoints.save_checkpoint(
                    self.run_dir / name, self.model, self.optimizer, epoch, self.mnt_best,
                    self.config, keep_copy="model_best.pth" if best else None)
        return log

    def resume(self, checkpoint_path) -> None:
        """Continue from a checkpoint: weights, and the optimizer state when
        the optimizer type is unchanged. Every rank reads the file, onto the
        host (a card's tensors would land on the card that saved them)."""
        payload = checkpoints.load_checkpoint(checkpoint_path, map_location="cpu")
        if not (isinstance(payload, dict) and isinstance(payload.get("config"), dict)
                and {"state_dict", "optimizer", "epoch", "monitor_best"} <= set(payload)):
            raise ValueError(f"{checkpoint_path} is not a checkpoint of one of the port's runs, "
                             "which resume continues; load its weights through the config's "
                             "arch.args.checkpoint_location")
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
