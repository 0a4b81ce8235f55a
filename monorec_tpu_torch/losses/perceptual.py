"""Perceptual (VGG16-feature) error (``monorec_tpu/losses/perceptual.py``,
the reference's ``PerceptualError``, ``common_losses.py:166-201``; no
shipped config uses it).

The feature extractor is the prefix of torchvision's ``vgg16().features``:
the first two convolutions with ``small_features``, else the first four and
one max-pool, laid out with torchvision's indices (0, 2, 5, 7), so its
``state_dict`` keys are ``features.<i>.weight`` / ``.bias``. The inputs are
ImageNet-normalized, and the error is the channel mean of the squared
feature difference.

The VGG16 weights are not in the repository and are not fetched: load them
from a local torchvision ``.pth`` (``load_vgg16_params``, or
``PerceptualError.load_torchvision``). Random weights still define a metric,
a meaningless one, so the module warns loudly the first time it runs
without loaded weights.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)
Tensor = torch.Tensor

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
_CONVS = (0, 2, 5, 7)  # torchvision's vgg16().features indices of the first four convolutions


def convert_torchvision_vgg16(state_dict: Dict, small_features: bool = False) -> Dict[str, Tensor]:
    """A torchvision ``vgg16().state_dict()`` (keys ``features.<i>.*``) or
    ``vgg16().features.state_dict()`` (keys ``<i>.*``) -> the
    ``PerceptualError`` state_dict of its prefix."""
    out = {}
    for idx in _CONVS[:2] if small_features else _CONVS:
        prefix = next((p for p in (f"features.{idx}", str(idx)) if f"{p}.weight" in state_dict),
                      None)
        if prefix is None:
            raise KeyError(f"no weights of vgg16 features.{idx} in the state_dict")
        for part in ("weight", "bias"):
            out[f"features.{idx}.{part}"] = torch.as_tensor(state_dict[f"{prefix}.{part}"])
    return out


def load_vgg16_params(path: Union[str, Path], small_features: bool = False) -> Dict[str, Tensor]:
    """Load a local torchvision VGG16 ``.pth`` as a ``PerceptualError``
    state_dict."""
    sd = torch.load(Path(path), map_location="cpu", weights_only=True)
    return convert_torchvision_vgg16(sd, small_features)


class PerceptualError(nn.Module):
    """``forward(img0, img1, mask=None)``: (N, 3, H, W) images in [0, 1] ->
    (N, H', W') errors, H' = H / 2 unless ``small_features``; with a
    (N, H, W) boolean ``mask`` (True = ignore), the masked pixels are zeroed
    in both inputs and the mask comes back too, at the errors' resolution:
    resized by an antialiased bilinear filter (``jax.image.resize``'s) and
    thresholded at > 0."""

    def __init__(self, small_features: bool = False):
        super().__init__()
        self.small_features = small_features
        layers = [nn.Conv2d(3, 64, 3, padding=1), nn.ReLU(), nn.Conv2d(64, 64, 3, padding=1),
                  nn.ReLU()]
        if not small_features:
            layers += [nn.MaxPool2d(2, 2), nn.Conv2d(64, 128, 3, padding=1), nn.ReLU(),
                       nn.Conv2d(128, 128, 3, padding=1), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_MEAN).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_STD).reshape(1, 3, 1, 1), persistent=False)
        self.weights_loaded = False
        self._warned = False

    def load_torchvision(self, source: Union[str, Path, Dict]) -> "PerceptualError":
        """Load torchvision VGG16 weights from a local ``.pth`` path or a
        state_dict (either key layout of ``convert_torchvision_vgg16``)."""
        sd = (load_vgg16_params(source, self.small_features) if isinstance(source, (str, Path))
              else convert_torchvision_vgg16(source, self.small_features))
        self.load_state_dict(sd)
        self.weights_loaded = True
        return self

    def _warn_random_weights(self) -> None:
        self._warned = True
        msg = ("PerceptualError runs on RANDOM VGG16 weights: no torchvision weights were "
               "loaded (PerceptualError.load_torchvision), so its error is not the reference's "
               "perceptual error.")
        logger.warning(msg)
        print(f"\n{'!' * 70}\nWARNING: {msg}\n{'!' * 70}\n", file=sys.stderr)

    def forward(self, img0: Tensor, img1: Tensor, mask: Optional[Tensor] = None):
        if not (self.weights_loaded or self._warned):
            self._warn_random_weights()
        n = img0.shape[0]
        img0 = (img0 - self.mean) / self.std
        img1 = (img1 - self.mean) / self.std
        if mask is not None:
            keep = (~mask.bool())[:, None].to(img0.dtype)
            img0, img1 = img0 * keep, img1 * keep
        x = self.features(torch.cat([img0, img1], 0))
        errors = ((x[n:] - x[:n]) ** 2).mean(1)
        if mask is None:
            return errors
        m = mask.to(torch.float32)
        if not self.small_features:
            m = F.interpolate(m[:, None], size=errors.shape[-2:], mode="bilinear",
                              align_corners=False, antialias=True)[:, 0]
        return errors, m > 0
