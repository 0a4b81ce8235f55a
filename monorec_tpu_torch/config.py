"""Reader of the reference's JSON configs (``configs/**/*.json``) for the
port: the counterpart of ``monorec_tpu/config/parser.py``, which the port
cannot import (it imports the flax model).

It maps ``arch.args`` onto ``MonoRecConfig``, ``loss``, ``metrics``,
``optimizer`` and ``lr_scheduler`` onto their ported counterparts,
``data_loader`` (and the point-cloud export's ``data_set``) onto the port's
datasets and loader, an evaluation config's ``models`` list onto model
configs, applies the CLI's key-path overrides (``--lr`` ->
``optimizer.args.lr``), and lays out the run directory
``<save_dir>/models/<name>/<timestamp>`` (``log/`` for an evaluation) with a
snapshot of the config. The top-level ``"precision"`` key selects the
precision policy (``precision.set_precision``) when the config is loaded,
and the model's dtype knobs it does not set come from that policy. Whatever a config asks
for that is not ported yet raises, naming it. ``cli/common.py`` builds the
CLIs' parsers and models on top of it.
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime
from functools import reduce
from operator import getitem
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from monorec_tpu_torch import parallel
from monorec_tpu_torch.models.monorec import MonoRecConfig
from monorec_tpu_torch.precision import apply_to_model_kwargs, set_precision

_MODEL_KEYS = {f.name for f in dataclasses.fields(MonoRecConfig)}
_LOADER_KEYS = {"batch_size", "shuffle", "validation_split", "num_workers", "drop_last",
                "start", "end", "every_nth"}


def load_config(config_path: Optional[str] = None, resume: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict:
    """The config dict: from ``config_path``, or from the ``config.json``
    beside a ``resume`` checkpoint (updated by ``config_path`` if given),
    with ``overrides`` ({"optimizer.args.lr": 1e-4, ...}) applied."""
    if resume is not None:
        with open(Path(resume).parent / "config.json") as f:
            config = json.load(f)
        if config_path is not None:
            with open(config_path) as f:
                config.update(json.load(f))
    elif config_path is None:
        raise ValueError("a config file is required (pass -c config.json)")
    else:
        with open(config_path) as f:
            config = json.load(f)
    for keypath, value in (overrides or {}).items():
        if value is not None:
            keys = keypath.split(".")
            reduce(getitem, keys[:-1], config)[keys[-1]] = value
    set_precision(config.get("precision", "exact"))
    return config


def make_run_dir(config: Dict, kind: str = "models") -> Path:
    """``<save_dir>/<kind>/<name>/<timestamp>``, created, with the config
    written into it. ``save_dir`` and the timestamp come from the
    ``trainer`` (or ``evaluater``) block, else from the top level; a
    ``timestamp_replacement`` there fixes the last part. The trainers use
    kind "models", the evaluation "log", as the JAX package does. In a
    data-parallel run rank 0 makes it and every rank gets rank 0's path
    (its clock names the folder)."""
    run_dir = None
    if parallel.is_main():
        section = config.get("trainer", config.get("evaluater", {}))
        save_dir = Path(section.get("save_dir", config.get("save_dir", "saved/")))
        ts = section.get("timestamp_replacement", config.get(
            "timestamp_replacement", datetime.now().strftime(r"%m%d_%H%M%S")))
        run_dir = save_dir / kind / config.get("name", "run") / ts
        run_dir.mkdir(parents=True, exist_ok=True)
        with open(run_dir / "config.json", "w") as f:
            json.dump(config, f, indent=4)
    return Path(parallel.broadcast_object(run_dir))


def build_model_config(arch_args: Dict) -> MonoRecConfig:
    """``arch.args`` of a ``MonoRecModel`` block -> ``MonoRecConfig``; the
    dtype knobs it leaves out come from the active precision policy."""
    kwargs = {}
    for key, value in arch_args.items():
        if key in _MODEL_KEYS:
            if key in ("inv_depth_min_max", "freeze_module"):
                value = tuple(value)
            elif key in ("pretrain_mode", "use_ssim", "pretrain_dropout_mode", "resnet_layers"):
                value = int(value)
            kwargs[key] = value
    return MonoRecConfig(**apply_to_model_kwargs(kwargs))


def checkpoint_locations(arch_args: Dict) -> Dict[str, Any]:
    """The weights ``arch.args`` names: the stage handoff's checkpoint paths
    (``checkpoint_location``, ``mask_cp_loc``, ``depth_cp_loc``), each as a
    list (a config may give one path or a list), and ``imagenet_weights``,
    the torchvision ResNet file (``models/pretrained.py``); empty keys left
    out."""
    from monorec_tpu_torch.train.checkpoints import STAGE_PREFIXES

    out: Dict[str, Any] = {}
    for key in STAGE_PREFIXES:
        value = arch_args.get(key)
        if value:
            out[key] = [str(v) for v in (value if isinstance(value, (list, tuple)) else [value])]
    if arch_args.get("imagenet_weights"):
        out["imagenet_weights"] = str(arch_args["imagenet_weights"])
    return out


def build_dataset(kind: str, args: Dict):
    """The dataset ``kind`` names (a dataset's class name, or a reference
    data loader's: ``KittiOdometryDataloader`` -> ``KittiOdometryDataset``)
    with its ``args``; the loader-only keys are left out."""
    from monorec_tpu_torch.data.cache import CachedDataset
    from monorec_tpu_torch.data.kitti import KittiOdometryDataset
    from monorec_tpu_torch.data.robotcar import OxfordRobotCarDataset
    from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset
    from monorec_tpu_torch.data.tum_mono_vo import TUMMonoVODataset
    from monorec_tpu_torch.data.tum_rgbd import TUMRGBDDataset

    datasets = {"KittiOdometryDataset": KittiOdometryDataset,
                "SyntheticSweepDataset": SyntheticSweepDataset, "CachedDataset": CachedDataset,
                "OxfordRobotCarDataset": OxfordRobotCarDataset,
                "TUMMonoVODataset": TUMMonoVODataset, "TUMRGBDDataset": TUMRGBDDataset}
    name = kind.replace("Dataloader", "Dataset")
    if name not in datasets:
        raise NotImplementedError(f"data set '{kind}' is not ported yet")
    return datasets[name](**{k: v for k, v in args.items() if k not in _LOADER_KEYS})


def build_data_loader(block: Dict, device):
    """A ``data_loader`` block -> the port's ``DataLoader`` on ``device``,
    with the block's ``num_workers`` (default 4, as the JAX parser's); its
    ``start`` / ``end`` / ``every_nth`` select a ``DatasetWrapper`` view."""
    from monorec_tpu_torch.data.loader import DataLoader, DatasetWrapper

    args = dict(block.get("args", {}))
    dataset = build_dataset(block["type"], args)
    if any(k in args for k in ("start", "end", "every_nth")):
        dataset = DatasetWrapper(dataset, start=args.get("start", 0), end=args.get("end", -1),
                                 every_nth=args.get("every_nth", 1))
    return DataLoader(dataset, batch_size=args.get("batch_size", 1),
                      shuffle=args.get("shuffle", True),
                      validation_split=args.get("validation_split", 0.0),
                      num_workers=args.get("num_workers", 4),
                      drop_last=args.get("drop_last", True), device=device)


def build_models(config: Dict) -> List:
    """(``MonoRecConfig``, checkpoint locations) of each block of an
    evaluation config's ``models`` list, or of its ``arch`` block."""
    blocks = config.get("models") or [config["arch"]]
    return [(build_model_config(b.get("args", {})), checkpoint_locations(b.get("args", {})))
            for b in blocks]


def build_loss(config: Dict):
    from monorec_tpu_torch.losses import LOSSES

    name = config["loss"]
    if name not in LOSSES:
        raise NotImplementedError(f"loss '{name}' is not ported yet (ported: {sorted(LOSSES)})")
    return LOSSES[name]


def build_metrics(config: Dict) -> Sequence:
    from monorec_tpu_torch.metrics import get_metric

    return [get_metric(name) for name in config.get("metrics", [])]


def build_optimizer(config: Dict, params, steps_per_epoch: int):
    from monorec_tpu_torch.train.state import make_optimizer

    return make_optimizer(params, config.get("optimizer"), config.get("lr_scheduler"),
                          steps_per_epoch)
