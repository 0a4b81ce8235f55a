"""Stage-1 training entry point of the port (``monorec_tpu/cli/train.py``).

    python -m monorec_tpu_torch.cli.train -c configs/train/monorec/monorec_depth.json
    python -m monorec_tpu_torch.cli.train -c configs/smoke/train_synthetic.json --device cpu
    python -m monorec_tpu_torch.cli.train -c configs/train/monorec/monorec_depth.json \
        --precision serving

Reads the same JSON configs as the JAX package. ``--lr`` and ``--bs``
override ``optimizer.args.lr`` and ``data_loader.args.batch_size``, and
``--precision`` the config's top-level ``"precision"`` key (the precision
policy, "exact" when neither sets it); ``-o``
passes loss options (``-o stereo`` adds the stereo frame to the depth
loss's reprojection); ``-r`` resumes from a checkpoint. The model starts
from seed-0 weights, then loads the checkpoints of earlier stages that
``arch.args`` names (``checkpoint_location``, ``mask_cp_loc``,
``depth_cp_loc``); every random draw comes from seed 0.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, Sequence, Type

import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.models import MonoRec
from monorec_tpu_torch.precision import POLICIES, set_precision
from monorec_tpu_torch.train import Trainer
from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints


def build_trainer(config: Dict, device, options: Sequence[str] = (), run_dir=None,
                  trainer_cls: Type[Trainer] = Trainer) -> Trainer:
    """The trainer (a ``trainer_cls``) of a config dict: loaders, model, loss,
    metrics and optimizer built from its blocks, on ``device``, under the
    precision policy of its ``"precision"`` key; the model holds the
    earlier stages' checkpoints that ``arch.args`` names."""
    set_precision(config.get("precision", "exact"))
    device = torch.device(device)
    data_loader = config_mod.build_data_loader(config["data_loader"], device)
    valid_loader = (config_mod.build_data_loader(config["val_data_loader"], device)
                    if "val_data_loader" in config else data_loader.split_validation())
    arch_args = config["arch"].get("args", {})
    model = MonoRec(config_mod.build_model_config(arch_args), device,
                    generator=torch.Generator().manual_seed(0))
    load_stage_checkpoints(model, config_mod.checkpoint_locations(arch_args))
    optimizer = config_mod.build_optimizer(
        config, [p for p in model.parameters() if p.requires_grad], len(data_loader))
    return trainer_cls(
        model, config_mod.build_loss(config), config_mod.build_metrics(config), optimizer,
        config, data_loader, valid_data_loader=valid_loader,
        run_dir=run_dir if run_dir is not None else config_mod.make_run_dir(config),
        options=options, generator=torch.Generator().manual_seed(0),
    )


def main(argv=None, trainer_cls: Type[Trainer] = Trainer,
         description: str = "monorec_tpu_torch stage-1 training") -> int:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", default=None, help="config file path")
    p.add_argument("-r", "--resume", default=None, help="checkpoint to resume")
    p.add_argument("-d", "--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("-o", "--options", default=[], nargs="+", help="loss options, e.g. stereo")
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--bs", default=None, type=int)
    p.add_argument("--precision", choices=sorted(POLICIES), default=None,
                   help="precision policy (default: the config's \"precision\", else exact)")
    args = p.parse_args(argv)

    config = config_mod.load_config(args.config, args.resume, {
        "optimizer.args.lr": args.lr, "data_loader.args.batch_size": args.bs,
        "precision": args.precision})
    verbosity = config.get("trainer", {}).get("verbosity", 2)
    logging.basicConfig(level={0: logging.WARNING, 1: logging.INFO}.get(verbosity, logging.DEBUG),
                        format="%(asctime)s %(levelname)s %(message)s")
    trainer = build_trainer(config, args.device, args.options, trainer_cls=trainer_cls)
    if args.resume:
        trainer.resume(args.resume)
    log = trainer.train()
    print(f"trained {log.get('epoch', 0)} epoch(s); loss {log.get('loss', float('nan')):.6f}; "
          f"run directory {trainer.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
