"""Checkpoints of the port: the reference's ``torch.save`` dict
``{arch, epoch, state_dict, optimizer, monitor_best, config}``
(``base/base_trainer.py`` of the original MonoRec; SURVEY section 5.4), so a
checkpoint of the port reads like one of the reference.

``load_checkpoint`` also reads the reference's own files, as its trainer
saved them, in the zip and in the legacy (before torch 1.6) format, without
ever unpickling in full (``weights_only``): the ``config`` there is the
pickled ``parse_config.ConfigParser``, which loads as ``ReferenceConfig``,
a stub of this module that only holds the pickled attributes (its
``pathlib.PosixPath`` folders among them); no module of the reference is
imported. Any other class in a file raises ``pickle.UnpicklingError``
naming it. ``state_dict`` takes the tensors of a loaded file, a bare state
dict too, with the keys stripped as the reference's loader strips them
(``strip_data_parallel``: ``module.`` of ``DataParallel``, ``0.`` of a
``Sequential(model, loss)``, keys that then start with a digit dropped).

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
import pathlib
import pickle
import re
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


class ReferenceConfig:
    """What the reference's pickled ``ConfigParser`` loads as: its
    attributes (``_config``, ``_save_dir``, ``_log_dir``, ``resume``, ...),
    and no behaviour."""


# The globals a checkpoint may hold beside tensors and containers, under
# the names its pickle gives them.
REFERENCE_GLOBALS = [(ReferenceConfig, "parse_config.ConfigParser"),
                     (ReferenceConfig, "utils.parse_config.ConfigParser"),
                     (pathlib.PosixPath, "pathlib.PosixPath")]


def load_checkpoint(path, map_location=None) -> Dict[str, Any]:
    """The checkpoint dict of ``path``, a port's or the reference's, zip or
    legacy format: tensors, numbers, strings, containers and, as
    ``ReferenceConfig``, the reference's ConfigParser with its paths."""
    try:
        with torch.serialization.safe_globals(REFERENCE_GLOBALS):
            return torch.load(Path(path), map_location=map_location, weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        what = f"the class {found.group(1)}" if found else f"what it cannot read ({e})"
        raise pickle.UnpicklingError(
            f"{path} holds {what}: this loader reads only tensors, containers and the "
            "reference's parse_config.ConfigParser") from None


def strip_data_parallel(state: Dict[str, Any]) -> Dict[str, Any]:
    """The keys as the reference's loader and the JAX package's converter
    (``convert.py::_strip_data_parallel``) read them: ``module.`` cut from
    every key where one key has it, then ``0.`` cut, and the keys that then
    start with a digit dropped."""
    if any(k.startswith("module.") for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    out = {}
    for k, v in state.items():
        if k.startswith("0."):
            k = k[2:]
        if k[0].isdigit():
            continue
        out[k] = v
    return out


def state_dict(payload) -> Dict[str, torch.Tensor]:
    """The tensors of a loaded checkpoint: its ``state_dict``, or the dict
    itself where it is a bare state dict (every value a tensor), the keys
    stripped (``strip_data_parallel``)."""
    if isinstance(payload, dict) and "state_dict" in payload:
        return strip_data_parallel(payload["state_dict"])
    if isinstance(payload, dict) and payload and all(
            isinstance(v, torch.Tensor) for v in payload.values()):
        return strip_data_parallel(payload)
    keys = sorted(payload)[:8] if isinstance(payload, dict) else type(payload).__name__
    raise ValueError(f"a checkpoint holds a 'state_dict' or only tensors; this one holds {keys}")


def _resolve(path) -> Path:
    """``path``, or ``path`` + ".pth" where only that exists (the shipped
    configs name the JAX package's checkpoint folders, ``.../checkpoint``)."""
    path = Path(path)
    with_suffix = path.with_name(path.name + ".pth")
    return with_suffix if not path.exists() and with_suffix.exists() else path


def load_submodule_state(model: torch.nn.Module, paths: Sequence,
                         prefix: str = "") -> List[str]:
    """Overwrite the tensors of ``model`` whose keys start with ``prefix``
    from the checkpoints at ``paths`` (the port's or the reference's, or
    bare state dicts), in order; keys the model lacks are skipped and a
    shape mismatch raises. Returns the keys loaded."""
    own = model.state_dict()
    loaded = []
    for path in paths:
        state = state_dict(load_checkpoint(_resolve(path), map_location="cpu"))
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
