"""Depth decoder: cost volume + keyframe -> 4-scale inverse depth
(``monorec_tpu/models/depth_module.py::DepthModule``).

A separable-conv encoder over ``cat(cost_volume, keyframe)``, a
transposed-conv decoder with skips from the CV encoder and the ResNet
features, and four heads ``abs(tanh(conv))`` in [0, 1] at full, 1/2, 1/4
and 1/8 resolution, returned finest first. ``dtype`` is the convolution
dtype: the cost volume, keyframe and features are cast to it at entry,
and the predictions return in float32. Submodule layout (``enc``,
``dec``, ``predictors``) is the reference's, for its ``state_dict`` keys.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from monorec_tpu_torch.models.layers import LEAKY_SLOPE, Refine, SamePadConv, SeparableConvLReLU
from monorec_tpu_torch.models.resnet import ENCODER_CHANNELS

Tensor = torch.Tensor


class DepthModule(nn.Module):
    """Returns a list of inverse-depth activations, finest resolution first."""

    def __init__(self, depth_steps: int = 32, large_model: bool = False,
                 feature_channels: Sequence[int] = ENCODER_CHANNELS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        e = (48, 64, 128, 256, 512) if large_model else (48, 64, 128, 192, 256)
        d = (512, 256, 128, 64, 32, 24) if large_model else (256, 128, 64, 48, 32, 24)
        feat = feature_channels
        kernels = (7, 7, 5, 5, 3)
        cins = (depth_steps + 3,) + e[:4]
        # Stride-2 downsampling from the second stage, each stage followed by
        # a k=3 refinement conv.
        self.enc = nn.ModuleList(
            [
                nn.Sequential(
                    SeparableConvLReLU(cin, ch, k, 1 if i == 0 else 2),
                    SeparableConvLReLU(ch, ch, 3),
                )
                for i, (cin, ch, k) in enumerate(zip(cins, e, kernels))
            ]
        )
        self.dec = nn.ModuleList(
            [
                Refine(e[4], d[0]),
                nn.Sequential(Refine(e[3] + feat[2] + d[0], d[1]), SeparableConvLReLU(d[1], d[1], 3)),
                nn.Sequential(Refine(e[2] + feat[1] + d[1], d[2]), SeparableConvLReLU(d[2], d[2], 3)),
                Refine(e[1] + feat[0] + d[2], d[3]),
                nn.Sequential(
                    SeparableConvLReLU(e[0] + d[3], d[4], 3),
                    nn.Identity(),
                    SamePadConv(d[4], d[5], 3, slope=LEAKY_SLOPE),
                ),
            ]
        )
        self.predictors = nn.ModuleList(
            [nn.Sequential(nn.Identity(), SamePadConv(c, 1, 3)) for c in (d[0], d[1], d[2], d[5])]
        )

    def _predict(self, x: Tensor, scale: int) -> Tensor:
        return torch.abs(torch.tanh(self.predictors[scale](x)))

    def forward(self, cost_volume: Tensor, keyframe: Tensor,
                image_features: Sequence[Tensor]) -> List[Tensor]:
        """cost_volume (B, D, H, W), keyframe (B, 3, H, W) -> [(B, 1, h, w)] x 4."""
        x = torch.cat([cost_volume, keyframe], 1).to(self.dtype)
        image_features = [f.to(self.dtype) for f in image_features]
        cv_feats = []
        for stage in self.enc:
            x = stage(x)
            cv_feats.append(x)

        preds: List[Tensor] = []
        x = self.dec[0](cv_feats[4])  # H/16 -> H/8
        preds.insert(0, self._predict(x, 0))
        x = self.dec[1](torch.cat([cv_feats[3], image_features[2], x], 1))  # -> H/4
        preds.insert(0, self._predict(x, 1))
        x = self.dec[2](torch.cat([cv_feats[2], image_features[1], x], 1))  # -> H/2
        preds.insert(0, self._predict(x, 2))
        x = self.dec[3](torch.cat([cv_feats[1], image_features[0], x], 1))  # -> H
        x = self.dec[4](torch.cat([cv_feats[0], x], 1))
        preds.insert(0, self._predict(x, 3))
        # Downstream (the affine depth map, losses, metrics) is float32.
        return [p.to(torch.float32) for p in preds]
