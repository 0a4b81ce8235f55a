"""Point-cloud export entry point of the port
(``monorec_tpu/cli/create_pointcloud.py``).

    python -m monorec_tpu_torch.cli.create_pointcloud -c configs/test/pointcloud_monorec.json
    python -m monorec_tpu_torch.cli.create_pointcloud -c <config> --device cpu

The config's ``data_set`` block, viewed from ``start`` to ``end``, is read
in order one frame at a time; the ``arch`` model (seed-0 weights, then the
checkpoints its args name) predicts each frame, and the world-frame PLY
goes to ``<output_dir>/<file_name>``, with the config's ``use_mask``,
``roi``, ``min_d`` and ``max_d`` and a dropout of 0.75. Arguments as in
``cli/evaluate.py`` (``cli/common.py``): ``-c``, ``-r`` (the config of a
checkpoint's run), ``-o`` (accepted and unused) and ``--device``, which
defaults to cuda.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.cli import common
from monorec_tpu_torch.data.loader import DataLoader, DatasetWrapper
from monorec_tpu_torch.export import export_pointcloud


def main(argv=None) -> int:
    args = common.standard_parser("monorec_tpu_torch point-cloud export").parse_args(argv)
    cfg = common.parse_config(args)
    device = torch.device(args.device)
    block = cfg["data_set"]
    dataset = DatasetWrapper(config_mod.build_dataset(block["type"], dict(block["args"])),
                             start=cfg.get("start", 0), end=cfg.get("end", -1))
    loader = DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False, device=device)
    (model_cfg, locations), = config_mod.build_models(cfg)
    model = common.init_model_with_checkpoints(model_cfg, locations, device)
    out = export_pointcloud(
        model, loader, Path(cfg.get("output_dir", "saved")) / cfg.get("file_name", "pc.ply"),
        use_mask=cfg.get("use_mask", True), roi=cfg.get("roi"), min_d=cfg.get("min_d", 3),
        max_d=cfg.get("max_d", 30))
    print(f"point cloud written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
