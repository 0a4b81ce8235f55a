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

On the card a float32 stride-1 ``SamePadConv`` whose kernel size and
channels ``ops/same_conv.py::takes`` admits (the narrow ones: 20 of the
46 stride-1 layers of a Mask + Depth forward) is one launch of the port's
own convolution kernel, which reads its same pad as zeros, adds the bias
and applies the LeakyReLU in its store. Every other convolution makes
one pass of its output beyond its own work: its same pad is the
convolution's own zero padding wherever that pad is symmetric (stride 1
with an odd kernel, or any stride where the size makes it so), and at
stride 1 with a pad one larger behind (the k=2 ``Upconv``), whose extra
leading output row or column is dropped: no padded copy of the input is
made. Only an asymmetric pad at a larger stride (the depth encoder's
stride-2 convolutions) is padded explicitly. ``pad_counts`` counts the
two ways by ``"implicit"`` (the kernel's pads among them) and
``"explicit"``. ``Refine``'s crop is its transposed convolution's padding
of 1. Those convolutions (cuDNN) run without their bias on the card, and
``ops/bias_act.py`` adds the bias and applies the LeakyReLU (or nothing)
in one pass over the kept output (``conv_bias_act``). bf16 inputs (the
serving policy) take that path at every stride.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from monorec_tpu_torch.ops.bias_act import conv_bias_act
from monorec_tpu_torch.ops.cuda import launch
from monorec_tpu_torch.ops.same_conv import same_conv, takes

Tensor = torch.Tensor
IntPair = Union[int, Tuple[int, int]]
LEAKY_SLOPE = 0.1
IDENTITY = 1.0  # LeakyReLU(1.0) is the identity, bit for bit

# SamePadConv calls by how their same pad was applied: "implicit" (the
# convolution's own padding) or "explicit" (a padded copy of the input).
pad_counts = launch.tally("layers.pad_counts")


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
    """TF-"same" conv computed in the dtype of its input, followed by
    LeakyReLU(``slope``); the default slope of 1.0 applies none."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, slope: float = IDENTITY):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        self.slope = slope

    def forward(self, x: Tensor) -> Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        h, w = x.shape[-2:]
        (top, bottom), (left, right) = same_pad_amounts(h, kh, sh), same_pad_amounts(w, kw, sw)
        weight, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if takes(x, self):
            pad_counts["implicit"] += 1
            return same_conv(x, weight, bias, self.slope, (top, left))
        if min(top, left) >= 0 and (top == bottom or sh == 1) and (left == right or sw == 1):
            # Pad the larger side on both: at stride 1, output j + (bottom -
            # top) of that convolution is output j of the asymmetric one, so
            # the extra leading output is dropped.
            pad_counts["implicit"] += 1
            return conv_bias_act(F.conv2d, x, weight, bias, self.slope,
                                 (bottom - top, right - left), stride=self.stride,
                                 padding=(bottom, right))
        pad_counts["explicit"] += 1
        return conv_bias_act(F.conv2d, pad_same(x, self.kernel_size, self.stride), weight, bias,
                             self.slope, stride=self.stride)


class ConvLReLU(nn.Module):
    """Same-pad conv + LeakyReLU(0.1) (reference ``ConvReLU``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1):
        super().__init__()
        self.conv = SamePadConv(in_channels, out_channels, kernel_size, stride, LEAKY_SLOPE)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class SeparableConvLReLU(nn.Module):
    """(k,1) conv + LeakyReLU, then (1,k) conv + LeakyReLU (reference ``ConvReLU2``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.conv_y = SamePadConv(in_channels, out_channels, (kernel_size, 1), (stride, 1),
                                  LEAKY_SLOPE)
        self.conv_x = SamePadConv(out_channels, out_channels, (1, kernel_size), (1, stride),
                                  LEAKY_SLOPE)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv_x(self.conv_y(x))


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
        weight, bias = t.weight.to(x.dtype), t.bias.to(x.dtype)
        if x.is_cuda:
            # A transposed convolution's padding of 1 leaves out the border
            # the crop drops, so the card computes only the kept output.
            return conv_bias_act(F.conv_transpose2d, x, weight, bias, LEAKY_SLOPE,
                                 stride=t.stride, padding=1)
        # The CPU's convolution sums the padded case in another order: crop
        # the whole output, as the plain layer does.
        y = conv_bias_act(F.conv_transpose2d, x, weight, bias, LEAKY_SLOPE, stride=t.stride)
        return y[:, :, 1:-1, 1:-1]


def max_pool_2x2(x: Tensor) -> Tensor:
    """2x2/2 max pool."""
    return F.max_pool2d(x, 2)
