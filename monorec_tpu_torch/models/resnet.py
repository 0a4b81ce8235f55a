"""ResNet feature encoder (``monorec_tpu/models/resnet.py``), NCHW.

Five feature scales (post-relu stem, layer1..layer4) at strides 2..32 with
channels ``encoder_channels(num_layers)``: (64, 64, 128, 256, 512) for
ResNet-18 and -34, the last four times 4 for the ``Bottleneck`` depths
50, 101 and 152. Input in [0, 1] is normalized as (x - 0.45) / 0.225. The
encoder is frozen in MonoRec, so BatchNorm always uses its running
statistics (``use_running_average=True`` on the JAX side), whatever the
module's train/eval mode. ``ResNetEncoder.encoder`` holds the
torchvision-named network, so keys read ``encoder.layer1.0.conv1.weight``
as in reference checkpoints and torchvision files. ``Bottleneck`` carries
its stride on the 3x3 conv (ResNet v1.5, as torchvision and the JAX
package).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

ENCODER_CHANNELS = (64, 64, 128, 256, 512)


def encoder_channels(num_layers: int) -> Tuple[int, ...]:
    """Channels of the five feature scales of ResNet-``num_layers``."""
    if num_layers > 34:
        return (ENCODER_CHANNELS[0],) + tuple(c * 4 for c in ENCODER_CHANNELS[1:])
    return ENCODER_CHANNELS


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalizes with its running statistics in every mode."""

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, momentum=0.0, eps=self.eps,
        )


def _downsample(in_channels: int, out_channels: int, stride: int):
    if stride == 1 and in_channels == out_channels:
        return None
    return nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, stride, bias=False),
                         FrozenBatchNorm2d(out_channels))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, width, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.downsample = _downsample(in_channels, width, stride)

    def forward(self, x: Tensor) -> Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class Bottleneck(nn.Module):
    """1x1 to ``width``, 3x3 with the stride, 1x1 to 4 x ``width``."""

    expansion = 4

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        out_channels = width * self.expansion
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_channels)
        self.downsample = _downsample(in_channels, out_channels, stride)

    def forward(self, x: Tensor) -> Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


_DEPTH_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class _ResNet(nn.Module):
    def __init__(self, num_layers: int):
        super().__init__()
        block, counts = _DEPTH_SPECS[num_layers]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for stage, (width, count) in enumerate(zip((64, 128, 256, 512), counts)):
            blocks = []
            for i in range(count):
                blocks.append(block(cin, width, 2 if stage > 0 and i == 0 else 1))
                cin = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResNetEncoder(nn.Module):
    """Five-scale feature pyramid. Call with NCHW images in [0, 1]."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers not in _DEPTH_SPECS:
            raise ValueError(f"unsupported resnet depth {num_layers} "
                             f"(one of {sorted(_DEPTH_SPECS)})")
        self.encoder = _ResNet(num_layers)

    def forward(self, x: Tensor) -> List[Tensor]:
        e = self.encoder
        x = (x - 0.45) / 0.225
        feats = [F.relu(e.bn1(e.conv1(x)))]
        x = F.max_pool2d(feats[0], 3, 2, 1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return feats
