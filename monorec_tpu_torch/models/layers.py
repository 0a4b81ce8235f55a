"""Layers with TensorFlow-"same" padding (``monorec_tpu/models/layers.py``).

Asymmetric same pads computed from kernel and stride, separable y-then-x
convolutions, 2x nearest upsampling followed by a k=2 conv, and a k=4/s=2
transposed conv cropped back to exactly 2x the input. NCHW; activations
are LeakyReLU(0.1). The convolutions compute in the dtype of their input:
they cast weight and bias to it inside ``forward`` (flax's
``nn.Conv(dtype=...)``), so the parameters and their gradients stay
float32 under the bf16 policy and float32 inputs run unchanged. Attribute names (``conv``, ``conv_y``/``conv_x``,
``conv2d_t``) are the reference's, so ``state_dict`` keys coincide with
reference checkpoints.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (v[0], v[1])


def same_pad_amounts(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-"same" asymmetric pad (floor on the leading side, ceil trailing)."""
    total = stride * (math.ceil(size / stride) - 1) + kernel - size
    return math.floor(total / 2), math.ceil(total / 2)


def pad_same(x: Tensor, kernel: IntPair, stride: IntPair = 1) -> Tensor:
    """Zero-pad an NCHW tensor for a following VALID conv to act as "same"."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    py = same_pad_amounts(x.shape[-2], kh, sh)
    px = same_pad_amounts(x.shape[-1], kw, sw)
    return F.pad(x, (px[0], px[1], py[0], py[1]))


class SamePadConv(nn.Conv2d):
    """TF-"same" pad followed by a VALID conv (no activation), computed in
    the dtype of its input."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride)

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(pad_same(x, self.kernel_size, self.stride), self.weight.to(x.dtype),
                        self.bias.to(x.dtype), self.stride)


class ConvLReLU(nn.Module):
    """Same-pad conv + LeakyReLU(0.1) (reference ``ConvReLU``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1):
        super().__init__()
        self.conv = SamePadConv(in_channels, out_channels, kernel_size, stride)

    def forward(self, x: Tensor) -> Tensor:
        return F.leaky_relu(self.conv(x), 0.1)


class SeparableConvLReLU(nn.Module):
    """(k,1) conv + LeakyReLU, then (1,k) conv + LeakyReLU (reference ``ConvReLU2``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.conv_y = SamePadConv(in_channels, out_channels, (kernel_size, 1), (stride, 1))
        self.conv_x = SamePadConv(out_channels, out_channels, (1, kernel_size), (1, stride))

    def forward(self, x: Tensor) -> Tensor:
        return F.leaky_relu(self.conv_x(F.leaky_relu(self.conv_y(x), 0.1)), 0.1)


def upsample_nearest_2x(x: Tensor) -> Tensor:
    """2x nearest-neighbor upsampling of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upconv(nn.Module):
    """2x nearest upsample + same-pad k=2 conv (reference ``Upconv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = SamePadConv(in_channels, out_channels, 2, 1)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(upsample_nearest_2x(x))


class Refine(nn.Module):
    """VALID k=4/s=2 transposed conv + LeakyReLU, then a 1-px crop to exactly 2x
    (reference ``Refine`` + ``PadSameConv2dTransposed``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv2d_t = nn.ConvTranspose2d(in_channels, out_channels, 4, 2)

    def forward(self, x: Tensor) -> Tensor:
        t = self.conv2d_t
        y = F.conv_transpose2d(x, t.weight.to(x.dtype), t.bias.to(x.dtype), t.stride)
        return F.leaky_relu(y, 0.1)[:, :, 1:-1, 1:-1]


def max_pool_2x2(x: Tensor) -> Tensor:
    """2x2/2 max pool."""
    return F.max_pool2d(x, 2)
