"""ImageNet-pretrained ResNet encoder (``monorec_tpu/models/pretrained.py``).

The reference freezes a torchvision ImageNet-pretrained ResNet-18
(``model/monorec/monorec_model.py:98-111,616-619``); a frozen random
encoder trains against meaningless features. The port's encoder already
carries torchvision's names under ``_feature_extractor.encoder.``, so a
torchvision ``resnet18-*.pth`` loads by a key map, without torchvision:

* ``find_imagenet_weights``: the ``MONOREC_TPU_IMAGENET_RESNET`` file (the
  JAX package's variable, so one setting serves both), else a torchvision
  file name in ``~/.cache/torch/hub/checkpoints`` or ``saved/weights``;
* ``convert_torchvision_resnet``: a torchvision ``state_dict`` under the
  port's keys (the classifier ``fc.*`` dropped; keys already prefixed pass
  through); a bottleneck file (ResNet-50/101/152) converts to nothing, as
  in the JAX package, whose converter refuses those, so only ResNet-18 and
  -34 files are injected;
* ``inject_imagenet_encoder``: loads such a file into a model's encoder, or
  refuses, without raising, a file whose keys are not the encoder's;
* ``warn_if_frozen_random_encoder``: the loud warning when a frozen encoder
  stays random.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

ENV_VAR = "MONOREC_TPU_IMAGENET_RESNET"
ENCODER_PREFIX = "_feature_extractor."
_HUB_NAMES = {
    18: ("resnet18-5c106cde.pth", "resnet18-f37072fd.pth", "resnet18.pth"),
    34: ("resnet34-333f7ec4.pth", "resnet34-b627a593.pth", "resnet34.pth"),
}


def _hub_dirs():
    return (Path.home() / ".cache" / "torch" / "hub" / "checkpoints", Path("saved/weights"))


def find_imagenet_weights(layers: int = 18) -> Optional[Path]:
    """The ImageNet ResNet file to load, or None: the environment variable's
    file where it exists, else the first torchvision name found in the hub
    cache, then in ``saved/weights``."""
    env = os.environ.get(ENV_VAR)
    if env and Path(env).exists():
        return Path(env)
    for d in _hub_dirs():
        for name in _HUB_NAMES.get(layers, ()):
            if (d / name).exists():
                return d / name
    return None


def _is_batch_counter(key: str) -> bool:
    return key.endswith(".num_batches_tracked")


def convert_torchvision_resnet(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` (``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ...; torch tensors or numpy arrays) ->
    the port's encoder keys (``_feature_extractor.encoder.conv1.weight``).
    The classifier (``fc.*``) is dropped; keys that already start with
    ``_feature_extractor.`` are kept as they are. A bottleneck ResNet
    (``layer1.0.conv3`` present) gives {}, which is logged."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("fc."):
            continue
        if not key.startswith(ENCODER_PREFIX):
            key = f"{ENCODER_PREFIX}encoder.{key}"
        out[key] = torch.as_tensor(value)
    if f"{ENCODER_PREFIX}encoder.layer1.0.conv3.weight" in out:
        logger.warning("a bottleneck ResNet (conv3 present) is not converted, as in the JAX "
                       "package (monorec_tpu.convert.Converter.convert_resnet)")
        return {}
    return out


def inject_imagenet_encoder(model: torch.nn.Module, path=None, layers: int = 18) -> bool:
    """Overwrite ``model``'s encoder with the ImageNet ResNet at ``path`` (or
    ``find_imagenet_weights(layers)`` when no path is given), on the
    model's device. Returns whether it did: False, without raising, when no
    file is found, or when the file's converted keys are not the encoder's
    (a ResNet-34 file under a ResNet-18 model), which is logged. BatchNorm's
    ``num_batches_tracked`` counters may be absent from the file (older
    torchvision files have none); the model keeps its own then."""
    p = Path(path) if path else find_imagenet_weights(layers)
    if p is None or not p.exists():
        return False
    weights = convert_torchvision_resnet(torch.load(p, map_location="cpu", weights_only=True))
    if not weights:
        logger.warning("%s contained no convertible ResNet weights", p)
        return False
    own = model.state_dict()
    want = {k for k in own if k.startswith(ENCODER_PREFIX) and not _is_batch_counter(k)}
    got = {k for k in weights if not _is_batch_counter(k)}
    if want != got or not set(weights) <= set(own):
        logger.warning("%s converts to a different encoder structure than the model (e.g. wrong "
                       "resnet_layers): %d unexpected / %d missing tensors; not injecting.",
                       p, len(got - want), len(want - got))
        return False
    model.load_state_dict(weights, strict=False)
    logger.info("Injected ImageNet ResNet-%d encoder weights from %s", layers, p)
    return True


def warn_if_frozen_random_encoder(freeze_resnet: bool, encoder_loaded: bool) -> None:
    """The reference freezes a PRETRAINED encoder; freezing a random one
    trains against meaningless features. Shout about it."""
    if not freeze_resnet or encoder_loaded:
        return
    msg = ("freeze_resnet=True but the ResNet encoder weights are RANDOM (no checkpoint and no "
           "ImageNet weights found). The reference freezes an ImageNet-pretrained encoder "
           "(monorec_model.py:98-111,616-619); training this way will not reproduce it. Either "
           f"provide weights ({ENV_VAR}=/path/to/resnet18.pth, or 'imagenet_weights' in the arch "
           "config) or set \"freeze_resnet\": false in the model args.")
    logger.warning(msg)
    print(f"\n{'!' * 70}\nWARNING: {msg}\n{'!' * 70}\n", file=sys.stderr)
