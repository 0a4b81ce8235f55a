"""What the port's CLIs share (``monorec_tpu/cli/common.py``): the parser,
the config with its overrides, the console log, and the model with the
weights its config names.

``-c`` names the config file; ``-r`` a checkpoint, whose run's
``config.json`` beside it is read (updated by ``-c`` where both are given);
``-d`` the torch device, cuda unless the caller asks for the CPU; ``-o``
options (the trainers' loss options; accepted and unused elsewhere, as in
the JAX package). The trainers add ``--lr`` and ``--bs``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict

import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.models.pretrained import (
    inject_imagenet_encoder,
    warn_if_frozen_random_encoder,
)
from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints


def standard_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", default=None, help="config file path")
    p.add_argument("-r", "--resume", default=None,
                   help="checkpoint; its run's config.json is read, updated by -c")
    p.add_argument("-d", "--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("-o", "--options", default=[], nargs="+",
                   help="free-form options, e.g. the loss's: stereo")
    return p


def train_overrides(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--lr", default=None, type=float, help="overrides optimizer.args.lr")
    p.add_argument("--bs", default=None, type=int, help="overrides data_loader.args.batch_size")
    return p


def parse_config(args: argparse.Namespace, with_train_overrides: bool = False) -> Dict:
    """The config dict of parsed ``args``: ``-c`` / ``-r``, with ``--lr`` and
    ``--bs`` where ``with_train_overrides``, and ``--precision`` where the
    parser has it."""
    overrides = {"precision": getattr(args, "precision", None)}
    if with_train_overrides:
        overrides.update({"optimizer.args.lr": args.lr, "data_loader.args.batch_size": args.bs})
    return config_mod.load_config(args.config, args.resume, overrides)


def console_logging(verbosity: int = 2) -> None:
    """The console log at ``verbosity`` (0 warning, 1 info, 2 debug)."""
    logging.basicConfig(level={0: logging.WARNING, 1: logging.INFO}.get(verbosity, logging.DEBUG),
                        format="%(asctime)s %(levelname)s %(message)s")


def init_model_with_checkpoints(model_cfg: MonoRecConfig, ckpts: Dict, device) -> MonoRec:
    """The seed-0 model on ``device`` with the weights ``ckpts`` names
    (``config.checkpoint_locations``): the stage checkpoints
    (``checkpoint_location``, then ``mask_cp_loc``, ``depth_cp_loc``), then,
    when no ``checkpoint_location`` brought an encoder, the ImageNet ResNet
    of ``imagenet_weights`` (or of ``MONOREC_TPU_IMAGENET_RESNET``, or the
    hub cache). Warns loudly when the frozen encoder stays random."""
    model = MonoRec(model_cfg, device, generator=torch.Generator().manual_seed(0))
    load_stage_checkpoints(model, ckpts)
    encoder_loaded = bool(ckpts.get("checkpoint_location"))
    if not encoder_loaded:
        encoder_loaded = inject_imagenet_encoder(model, ckpts.get("imagenet_weights"),
                                                 model_cfg.resnet_layers)
    warn_if_frozen_random_encoder(model_cfg.freeze_resnet, encoder_loaded)
    return model
