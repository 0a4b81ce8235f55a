"""Checkpoints of the port: the reference's ``torch.save`` dict
``{arch, epoch, state_dict, optimizer, monitor_best, config}``
(``base/base_trainer.py`` of the original MonoRec; SURVEY section 5.4), so a
checkpoint of the port reads like one of the reference. The stage-handoff
partial loads (``checkpoint_location``, ``mask_cp_loc``, ``depth_cp_loc``)
come with the stage 2-4 port slice.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch


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
