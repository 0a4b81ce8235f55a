"""ResNet-18 feature encoder (``monorec_tpu/models/resnet.py``), NCHW.

Five feature scales (post-relu stem, layer1..layer4) at strides 2..32 with
channels (64, 64, 128, 256, 512). Input in [0, 1] is normalized as
(x - 0.45) / 0.225. The encoder is frozen in MonoRec, so BatchNorm always
uses its running statistics (``use_running_average=True`` on the JAX side),
whatever the module's train/eval mode. ``ResNetEncoder.encoder`` holds the
torchvision-named network, so keys read ``encoder.layer1.0.conv1.weight``
as in reference checkpoints. ``Bottleneck`` depths (50/101/152) and 34 are
not ported yet.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

ENCODER_CHANNELS = (64, 64, 128, 256, 512)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalizes with its running statistics in every mode."""

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, momentum=0.0, eps=self.eps,
        )


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(out_channels)
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, stride, bias=False),
                FrozenBatchNorm2d(out_channels),
            )

    def forward(self, x: Tensor) -> Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class _ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        widths = (64, 128, 256, 512)
        cin = 64
        for stage, width in enumerate(widths):
            stride = 1 if stage == 0 else 2
            layer = nn.Sequential(BasicBlock(cin, width, stride), BasicBlock(width, width))
            setattr(self, f"layer{stage + 1}", layer)
            cin = width


class ResNetEncoder(nn.Module):
    """Five-scale feature pyramid. Call with NCHW images in [0, 1]."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers != 18:
            raise ValueError(f"ResNet-{num_layers} is not ported yet; only ResNet-18 is")
        self.encoder = _ResNet18()

    def forward(self, x: Tensor) -> List[Tensor]:
        e = self.encoder
        x = (x - 0.45) / 0.225
        feats = [F.relu(e.bn1(e.conv1(x)))]
        x = F.max_pool2d(feats[0], 3, 2, 1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return feats
