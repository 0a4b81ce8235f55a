"""Evaluation entry point of the port (``monorec_tpu/cli/evaluate.py``).

    python -m monorec_tpu_torch.cli.evaluate -c configs/evaluate/eval_monorec.json
    python -m monorec_tpu_torch.cli.evaluate -c <config> --device cpu
    python -m monorec_tpu_torch.cli.evaluate -r saved/models/<name>/<run>/checkpoint.pth

Each model of the config's ``models`` list (or its ``arch`` block) starts
from seed-0 weights, loads the checkpoints its args name (the port's
``.pth`` files, ``train/checkpoints.py``; ``cli/common.py``), and is
evaluated over the ``data_loader`` with the config's ``metrics``;
``results_<i>.json`` goes into ``<save_dir>/log/<name>/<timestamp>`` (the
``evaluater`` block's), and the metric dict is printed. ``-r`` reads the
config of a checkpoint's run (``config.json`` beside it, updated by
``-c``); ``-o`` is accepted and unused, as in the JAX package.
``--device`` defaults to cuda.
"""

from __future__ import annotations

import json
import sys
from typing import List

import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.cli import common
from monorec_tpu_torch.eval import Evaluator


def main(argv=None) -> int:
    args = common.standard_parser("monorec_tpu_torch evaluation").parse_args(argv)
    config = common.parse_config(args)
    common.console_logging(config.get("evaluater", {}).get("verbosity", 2))
    device = torch.device(args.device)
    data_loader = config_mod.build_data_loader(config["data_loader"], device)
    metric_fns = config_mod.build_metrics(config)
    run_dir = config_mod.make_run_dir(config, "log")
    results: List[str] = []
    for i, (model_cfg, locations) in enumerate(config_mod.build_models(config)):
        model = common.init_model_with_checkpoints(model_cfg, locations, device)
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
