"""Point-cloud export entry point of the port
(``monorec_tpu/cli/create_pointcloud.py``).

    python -m monorec_tpu_torch.cli.create_pointcloud -c configs/test/pointcloud_monorec.json
    python -m monorec_tpu_torch.cli.create_pointcloud -c <config> --device cpu

The config's ``data_set`` block, viewed from ``start`` to ``end``, is read
in order one frame at a time; the ``arch`` model (seed-0 weights, then the
checkpoints its args name) predicts each frame, and the world-frame PLY
goes to ``<output_dir>/<file_name>``, with the config's ``use_mask``,
``roi``, ``min_d`` and ``max_d`` and a dropout of 0.75. ``--device``
defaults to cuda.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.data.loader import DataLoader, DatasetWrapper
from monorec_tpu_torch.export import export_pointcloud
from monorec_tpu_torch.models import MonoRec
from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="monorec_tpu_torch point-cloud export")
    p.add_argument("-c", "--config", required=True, help="config file path")
    p.add_argument("-d", "--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)

    cfg = config_mod.load_config(args.config)
    device = torch.device(args.device)
    block = cfg["data_set"]
    dataset = DatasetWrapper(config_mod.build_dataset(block["type"], dict(block["args"])),
                             start=cfg.get("start", 0), end=cfg.get("end", -1))
    loader = DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False, device=device)
    (model_cfg, locations), = config_mod.build_models(cfg)
    model = MonoRec(model_cfg, device, generator=torch.Generator().manual_seed(0))
    load_stage_checkpoints(model, locations)
    out = export_pointcloud(
        model, loader, Path(cfg.get("output_dir", "saved")) / cfg.get("file_name", "pc.ply"),
        use_mask=cfg.get("use_mask", True), roi=cfg.get("roi"), min_d=cfg.get("min_d", 3),
        max_d=cfg.get("max_d", 30))
    print(f"point cloud written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
