"""Checkpoints of the port: the reference's ``torch.save`` dict
``{arch, epoch, state_dict, optimizer, monitor_best, config}``
(``base/base_trainer.py`` of the original MonoRec; SURVEY section 5.4), so a
checkpoint of the port reads like one of the reference.

The stage handoff (``load_stage_checkpoints``) fills a new model from the
checkpoints of earlier stages, as the reference's ``MonoRecModel.__init__``
and the JAX package's ``cli/common.py::init_state_with_checkpoints`` do:
``checkpoint_location`` loads every tensor the checkpoint and the model
share, ``mask_cp_loc`` only ``att_module.*`` and ``depth_cp_loc`` only
``depth_module.*``, in that order. Buffers load with their parameters, as
the reference's ``load_state_dict`` does (the JAX package carries
parameters only; the only buffers are the frozen encoder's BatchNorm
statistics).
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)

# What each handoff key loads: a state_dict key prefix ("" = everything).
STAGE_PREFIXES = {"checkpoint_location": "", "mask_cp_loc": "att_module.",
                  "depth_cp_loc": "depth_module."}


def save_checkpoint(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer, epoch: int,
                    monitor_best: float, config: Dict, keep_copy: Optional[str] = None) -> Path:
    """Write the checkpoint dict to ``path``; optionally copy it to the name
    ``keep_copy`` beside it (e.g. ``model_best.pth``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({
        "arch": type(model).__name__,
        "epoch": epoch,
        "state_dict": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "monitor_best": float(monitor_best),
        "config": config,
    }, path)
    if keep_copy:
        shutil.copyfile(path, path.parent / keep_copy)
    return path


def load_checkpoint(path, map_location=None) -> Dict[str, Any]:
    """The checkpoint dict (tensors, numbers, strings and containers only)."""
    return torch.load(Path(path), map_location=map_location, weights_only=True)


def _resolve(path) -> Path:
    """``path``, or ``path`` + ".pth" where only that exists (the shipped
    configs name the JAX package's checkpoint folders, ``.../checkpoint``)."""
    path = Path(path)
    with_suffix = path.with_name(path.name + ".pth")
    return with_suffix if not path.exists() and with_suffix.exists() else path


def load_submodule_state(model: torch.nn.Module, paths: Sequence,
                         prefix: str = "") -> List[str]:
    """Overwrite the tensors of ``model`` whose keys start with ``prefix``
    from the checkpoints at ``paths``, in order; keys the model lacks are
    skipped and a shape mismatch raises. Returns the keys loaded."""
    own = model.state_dict()
    loaded = []
    for path in paths:
        state = load_checkpoint(_resolve(path), map_location="cpu")["state_dict"]
        picked = {k: v for k, v in state.items() if k.startswith(prefix) and k in own}
        if not picked:
            logger.warning("%s holds no tensor of this model under '%s'", path, prefix)
        model.load_state_dict(picked, strict=False)
        loaded += list(picked)
    return loaded


def load_stage_checkpoints(model: torch.nn.Module, locations: Dict[str, Sequence]) -> None:
    """The stage handoff: ``locations`` maps ``checkpoint_location``,
    ``mask_cp_loc`` and ``depth_cp_loc`` to lists of the port's checkpoint
    files (``config.checkpoint_locations``)."""
    for key, prefix in STAGE_PREFIXES.items():
        if locations.get(key):
            keys = load_submodule_state(model, locations[key], prefix)
            logger.info("%s: loaded %d tensors from %s", key, len(keys), locations[key])
