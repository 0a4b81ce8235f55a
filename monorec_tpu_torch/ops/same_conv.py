"""The U-Nets' stride-1 same-padded convolutions with their bias and
LeakyReLU in one launch: the port's own float32 kernel
(``cuda/same_conv.cu``; no Pallas counterpart: the JAX package leaves these
convolutions to XLA).

``same_conv(x, weight, bias, slope, pad)`` is ``act(conv(x, weight) + bias)``
for NCHW float32 at stride 1, with ``act(v) = v if v > 0 else v * slope``
and TensorFlow's "same" pad: ``pad`` = (top, left) zeros before the planes,
``k - 1 - top`` and ``k - 1 - left`` after them, so the output has the
input's planes. On CUDA tensors it launches the kernel (built at first use);
on CPU tensors it runs the plain version, ``same_conv_reference``, which
sums the taps one by one. Under autograd it is a
``torch.autograd.Function``: forward the kernel, backward the epilogue's
backward (``bias_act_bwd``: the pre-activation's and the bias's gradients)
and ``aten.convolution_backward`` for the input's and the weight's, the
computation the cuDNN path's autograd makes.

``takes(x, conv)`` is the routing rule ``SamePadConv`` asks: a CUDA float32
input at stride 1, a kernel size the kernel is built for, and the
channels of ``admits``. The rule reads only the dtype, the stride, the
kernel size and the channels. bf16 (the serving policy), stride 2 and the
rest stay on cuDNN and ``bias_act``; each CUDA float32 stride-1 call the
rule sends there counts on ``same_conv.routed_library``.
``same_conv.launches`` counts launches, ``.launches_by_shape`` them by
(N, C_in, H, W, C_out, kh, kw).

The kernel's tile comes from the shape (``plan``): 32 or 24 output
channels a block, whichever leaves fewer idle, or 8 with a shorter strip
where that finishes sooner (small planes, channel counts of neither).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from monorec_tpu_torch.ops.bias_act import bias_act_bwd
from monorec_tpu_torch.ops.cuda import launch

Tensor = torch.Tensor

# (kh, kw) the kernel is built for.
KERNELS = ((3, 3), (2, 2), (7, 1), (5, 1), (3, 1), (1, 7), (1, 5), (1, 3))
# The kernel's configurations, as same_conv.cu numbers them: (pixels a
# thread holds along its strip, output channels a thread holds, warps along
# the strip, warps along the channels). A block's tile is 32 x (strip x
# warps along it) pixels by (channels x warps along them) channels.
CONFIGS = ((8, 8, 2, 4), (8, 8, 2, 3), (4, 8, 4, 1))
# Each configuration's rate relative to the first on the card, for a 3x3
# kernel and for the others: a 4-pixel strip reloads more inputs per
# operation, which costs where the taps are few.
CONFIG_RATES = ((1.0, 1.0), (1.0, 1.0), (1.0, 0.8))
# Warps an SM needs resident for its full rate (the plan's model).
SATURATING_WARPS = 12
# The routing rule's bounds, from the kernel's and cuDNN's times at every
# stride-1 shape of the U-Nets on the H100 (PERF.md): with at most
# NARROW channels on a side (the 1-channel predictors among them) cuDNN's
# implicit GEMM leaves most of its channel tile idle and the kernel is
# faster at every shape; with both sides wider cuDNN fills its tile and is
# as fast or faster at some shape, but for a 2x2 kernel (its GEMM is only 4
# taps deep). Over more than MAX_C_IN input channels the layers sit on the
# smallest planes, where the kernel's tiles are too few to fill the card.
NARROW = 48
MAX_C_IN = 128


def admits(dtype: torch.dtype, stride: Sequence[int], kernel_size: Sequence[int], c_in: int,
           c_out: int) -> bool:
    """The routing rule: whether the kernel takes a convolution of these."""
    kernel = tuple(kernel_size)
    return (dtype == torch.float32 and tuple(stride) == (1, 1) and kernel in KERNELS
            and c_in <= MAX_C_IN and (min(c_in, c_out) <= NARROW or kernel == (2, 2)))


def takes(x: Tensor, conv: torch.nn.Conv2d) -> bool:
    """Whether ``conv`` (stride, kernel size, channels) on ``x`` runs the
    kernel: CUDA tensors that ``admits`` takes. Counts the CUDA float32
    stride-1 calls it leaves to the library."""
    if not x.is_cuda:
        return False
    if admits(x.dtype, conv.stride, conv.kernel_size, conv.in_channels, conv.out_channels):
        return True
    if x.dtype == torch.float32 and tuple(conv.stride) == (1, 1):
        same_conv.routed_library += 1
    return False


def same_pads(kh: int, kw: int) -> Tuple[int, int]:
    """(top, left) of a stride-1 TF-"same" pad: the floor half of k - 1."""
    return (kh - 1) // 2, (kw - 1) // 2


def same_conv_reference(x: Tensor, weight: Tensor, bias: Tensor, slope: float = 1.0,
                        pad: Tuple[int, int] = (0, 0)) -> Tensor:
    """Plain version: zero-pad, then sum the taps one by one (each a
    contraction over the input channels), add the bias, activate."""
    kh, kw = weight.shape[-2:]
    top, left = pad
    h, w = x.shape[-2:]
    xp = F.pad(x, (left, kw - 1 - left, top, kh - 1 - top))
    acc = x.new_zeros(x.shape[0], weight.shape[0], h, w)
    for ky in range(kh):
        for kx in range(kw):
            acc = acc + torch.einsum("nchw,oc->nohw", xp[:, :, ky:ky + h, kx:kx + w],
                                     weight[:, :, ky, kx])
    v = acc + bias.view(1, -1, 1, 1)
    return v if slope == 1.0 else F.leaky_relu(v, slope)


_LAUNCH = launch.Entry("same_conv", "same_conv_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BLOCKS_PER_SM = launch.Entry("same_conv", "same_conv_blocks_per_sm", [ctypes.c_int] * 3)


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, kh: int, kw: int) -> Tuple[int, Tuple[int, ...]]:
    """The card's SMs, and the blocks of each configuration an SM holds."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    with torch.cuda.device(device_index):
        return sms, tuple(_BLOCKS_PER_SM(kh, kw, i) for i in range(len(CONFIGS)))


def tiles(n: int, h: int, w: int, c_out: int, kernel: Sequence[int], config: int) -> int:
    """The kernel's output tiles (its blocks) in ``config``. The
    strip runs along x for a 1 x k kernel, along y else."""
    tm, tn, ws, wc = CONFIGS[config]
    lane_extent, strip_extent = (h, w) if kernel[0] == 1 and kernel[1] > 1 else (w, h)
    return n * -(-c_out // (tn * wc)) * -(-lane_extent // 32) * -(-strip_extent // (tm * ws))


def plan(n: int, h: int, w: int, c_out: int, kernel: Sequence[int], sms: int,
         blocks_per_sm: Sequence[int]) -> int:
    """The configuration that finishes the convolution soonest by a model of
    the card: blocks spread evenly over the SMs, each SM runs up to
    ``blocks_per_sm`` of them at a time at the configuration's rate, scaled
    down where fewer than ``SATURATING_WARPS`` warps are resident, and a
    block's time is its whole tile's (idle channels and pixels included)."""
    k3x3 = tuple(kernel) == (3, 3)
    best, best_cost = 0, math.inf
    for i, (tm, tn, ws, wc) in enumerate(CONFIGS):
        if blocks_per_sm[i] <= 0:
            continue
        per_sm = -(-tiles(n, h, w, c_out, kernel, i) // sms)
        resident = min(per_sm, blocks_per_sm[i])
        share = min(1.0, resident * ws * wc / SATURATING_WARPS)
        cost = (-(-per_sm // resident) * resident * 32 * tm * ws * tn * wc
                / (CONFIG_RATES[i][0 if k3x3 else 1] * share))
        if cost < best_cost:
            best, best_cost = i, cost
    return best


@functools.lru_cache(maxsize=None)
def _planned(device_index: int, n: int, h: int, w: int, c_out: int, kh: int, kw: int) -> int:
    """``plan``'s configuration for a shape on a card, worked out once."""
    return plan(n, h, w, c_out, (kh, kw), *_occupancy(device_index, kh, kw))


def _check(x: Tensor, weight: Tensor, bias: Tensor, pad: Tuple[int, int]) -> None:
    if not x.is_cuda:
        raise ValueError(f"same_conv runs on CUDA or CPU tensors, not {x.device}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (N, C_in, H, W) and weight (C_out, C_in, kh, kw), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if tuple(weight.shape[-2:]) not in KERNELS:
        raise ValueError(f"same_conv is built for kernels {KERNELS}, not "
                         f"{tuple(weight.shape[-2:])}")
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {x.device}")
    top, left = pad
    if not (0 <= top < weight.shape[2] and 0 <= left < weight.shape[3]):
        raise ValueError(f"pad {pad} must lie inside the kernel {tuple(weight.shape[-2:])}")


def same_conv_fwd(x: Tensor, weight: Tensor, bias: Tensor, slope: float = 1.0,
                  pad: Tuple[int, int] = (0, 0),
                  config: Optional[int] = None) -> Tensor:
    """``act(conv(x, weight) + bias)``, same pad ``pad``; CUDA tensors launch
    the kernel (in ``config``, by default ``plan``'s), CPU tensors run the
    plain version."""
    if x.device.type == "cpu":
        return same_conv_reference(x, weight, bias, slope, pad)
    _check(x, weight, bias, pad)
    n, c_in, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    if config is None:
        config = _planned(x.device.index, n, h, w, c_out, kh, kw)
    out = torch.empty(n, c_out, h, w, dtype=x.dtype, device=x.device)
    _LAUNCH.launch("same_conv", x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), n, c_in, h, w, c_out, kh, kw, pad[0], pad[1], slope, config)
    same_conv.launches += 1
    same_conv.launches_by_shape[(n, c_in, h, w, c_out, kh, kw)] += 1
    return out


class _SameConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, weight: Tensor, bias: Tensor, slope: float,
                pad: Tuple[int, int]) -> Tensor:
        out = same_conv_fwd(x, weight, bias, slope, pad)
        ctx.save_for_backward(x, weight, out if slope != 1.0 else None)
        ctx.slope, ctx.pad = slope, pad
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        x, weight, out = ctx.saved_tensors
        (top, left), (kh, kw) = ctx.pad, weight.shape[-2:]
        bottom, right = kh - 1 - top, kw - 1 - left
        n, _, h, w = x.shape
        # The convolution padded by (bottom, right) on both sides, as the
        # cuDNN path runs it, less its first (bottom - top, right - left)
        # rows and columns.
        dy, dx = bottom - top, right - left
        y_shape = (n, weight.shape[0], h + dy, w + dx)
        grad_y, grad_bias = bias_act_bwd(g.contiguous(), out, ctx.slope,
                                         (dy, dx, h, w) if dy or dx else None, y_shape)
        grad_x, grad_w, _ = torch.ops.aten.convolution_backward(
            grad_y, x, weight, None, [1, 1], [bottom, right], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return grad_x, grad_w, grad_bias.to(g.dtype), None, None


@launch.counted("launches", "launches_by_shape", "routed_library")
def same_conv(x: Tensor, weight: Tensor, bias: Tensor, slope: float = 1.0,
              pad: Tuple[int, int] = (0, 0)) -> Tensor:
    """``act(conv(x, weight) + bias)`` at stride 1 with the same pad ``pad`` =
    (top, left), differentiable in x, weight and bias."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _SameConv.apply(x, weight, bias, slope, tuple(pad))
    return same_conv_fwd(x, weight, bias, slope, tuple(pad))
