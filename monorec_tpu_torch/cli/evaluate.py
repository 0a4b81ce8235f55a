"""Evaluation entry point of the port (``monorec_tpu/cli/evaluate.py``).

    python -m monorec_tpu_torch.cli.evaluate -c configs/evaluate/eval_monorec.json
    python -m monorec_tpu_torch.cli.evaluate -c <config> --device cpu

Each model of the config's ``models`` list (or its ``arch`` block) starts
from seed-0 weights, loads the checkpoints its args name (the port's
``.pth`` files, ``train/checkpoints.py``), and is evaluated over the
``data_loader`` with the config's ``metrics``; ``results_<i>.json`` goes
into ``<save_dir>/log/<name>/<timestamp>`` (the ``evaluater`` block's), and
the metric dict is printed. ``--device`` defaults to cuda.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List

import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.eval import Evaluator
from monorec_tpu_torch.models import MonoRec
from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="monorec_tpu_torch evaluation")
    p.add_argument("-c", "--config", required=True, help="config file path")
    p.add_argument("-d", "--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)

    config = config_mod.load_config(args.config)
    verbosity = config.get("evaluater", {}).get("verbosity", 2)
    logging.basicConfig(level={0: logging.WARNING, 1: logging.INFO}.get(verbosity, logging.DEBUG),
                        format="%(asctime)s %(levelname)s %(message)s")
    device = torch.device(args.device)
    data_loader = config_mod.build_data_loader(config["data_loader"], device)
    metric_fns = config_mod.build_metrics(config)
    run_dir = config_mod.make_run_dir(config, "log")
    results: List[str] = []
    for i, (model_cfg, locations) in enumerate(config_mod.build_models(config)):
        model = MonoRec(model_cfg, device, generator=torch.Generator().manual_seed(0))
        load_stage_checkpoints(model, locations)
        evaluator = Evaluator(model, metric_fns, config, data_loader, run_dir)
        log = evaluator.eval()
        extra = {"model": {"config": str(model_cfg)},
                 "dataset": {"type": config["data_loader"]["type"],
                             "args": config["data_loader"]["args"]}}
        results.append(str(evaluator.save_results(log, extra, name=f"results_{i}.json")))
        print(json.dumps({m.__name__: log[m.__name__] for m in metric_fns}, indent=2))
    print("results written:", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
