"""The U-Nets' convolution epilogue: per-channel bias and LeakyReLU in one
pass, the port's own kernel (``cuda/bias_act.cu``; no Pallas counterpart).

``bias_act(y, bias, slope, window)`` is ``act(y[window] + bias[c])`` with
``act(v) = v if v > 0 else v * slope``: ``slope`` 0.1 after an activated
convolution, 1.0 (the identity) after one that is not. ``window`` =
``(top, left, h, w)`` takes the rows and columns of y's planes that the
layer keeps (None: all of them); the output is a new contiguous
``(N, C, h, w)`` tensor. y and bias share a dtype, float32 or bf16.

On CUDA tensors it launches the kernel (built at first use); on CPU tensors
it runs the plain version, ``y + bias`` then ``leaky_relu``. Under autograd
it is a ``torch.autograd.Function`` whose backward is the kernel's backward
(the plain one on the CPU): ``g * (out > 0 ? 1 : slope)`` into y's gradient,
zero outside the window, and its per-channel sums as the bias gradient.
``out > 0`` exactly where the pre-activation is, so at a pre-activation of
exactly 0 the gradient takes the slope, as torch's LeakyReLU does.
``bias_act.launches`` counts forward launches, ``.launches_bwd`` backward
ones, on either dtype.

``conv_bias_act`` is what the U-Nets' layers call: a convolution, its bias
and its activation, through this kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from monorec_tpu_torch.ops.cuda import launch

Tensor = torch.Tensor
Window = Optional[Tuple[int, int, int, int]]


def _view(y: Tensor, window: Window) -> Tensor:
    if window is None:
        return y
    top, left, h, w = window
    return y[:, :, top:top + h, left:left + w]


def bias_act_reference(y: Tensor, bias: Tensor, slope: float = 1.0,
                       window: Window = None) -> Tensor:
    """Plain version: the add and the activation as two ATen operations."""
    v = _view(y, window) + bias.view(1, -1, 1, 1)
    return v if slope == 1.0 else F.leaky_relu(v, slope)


def _bias_act_bwd_reference(g: Tensor, out: Optional[Tensor], slope: float, window: Window,
                            y_shape) -> Tuple[Tensor, Tensor]:
    d = g if slope == 1.0 else torch.where(out > 0, g, g * slope)
    grad_bias = d.sum((0, 2, 3), dtype=torch.promote_types(d.dtype, torch.float32))
    if window is None:
        return d, grad_bias
    grad_y = d.new_zeros(y_shape)
    _view(grad_y, window).copy_(d)
    return grad_y, grad_bias


_WINDOW = [ctypes.c_int] * 6
_FWD = launch.Entry("bias_act", "bias_act_fwd_launch",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + _WINDOW
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD = launch.Entry("bias_act", "bias_act_bwd_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + _WINDOW
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_CHUNK_ELEMS = launch.Entry("bias_act", "bias_act_chunk_elems", [])


def _kept(shape, window: Window) -> Window:
    """``window``, or None where it covers the whole (.., H, W) plane: the
    kernel's whole-plane paths then serve it on both sides."""
    if window is not None and tuple(window) == (0, 0, *shape[-2:]):
        return None
    return window


def _dims(y: Tensor, window: Window):
    """N, C, Hy, Wy, top, left, h, w."""
    n, c, hy, wy = y.shape
    top, left, h, w = window if window is not None else (0, 0, hy, wy)
    return n, c, hy, wy, top, left, h, w


def _check(y: Tensor, window: Window) -> None:
    if not y.is_cuda:
        raise ValueError(f"bias_act runs on CUDA or CPU tensors, not {y.device}")
    if y.dim() != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bias_act takes float32 or bf16, got {y.dtype}")
    _, _, hy, wy, top, left, h, w = _dims(y, window)
    if not (0 <= top and 0 <= left and 0 < h and 0 < w and top + h <= hy and left + w <= wy):
        raise ValueError(f"window {window} lies outside the planes ({hy}, {wy})")
    if not y.is_contiguous():
        raise ValueError("bias_act takes contiguous tensors")


def bias_act_fwd(y: Tensor, bias: Tensor, slope: float = 1.0, window: Window = None) -> Tensor:
    """``act(y[window] + bias[c])``; CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    if y.device.type == "cpu":
        return bias_act_reference(y, bias, slope, window)
    window = _kept(y.shape, window)
    _check(y, window)
    if bias.shape != (y.shape[1],) or bias.dtype != y.dtype or bias.device != y.device:
        raise ValueError(f"bias must be ({y.shape[1]},) {y.dtype} on {y.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    dims = _dims(y, window)
    n, c, *_, h, w = dims
    out = torch.empty(n, c, h, w, dtype=y.dtype, device=y.device)
    _FWD.launch("bias_act_fwd", y.device, y.data_ptr(), bias.data_ptr(), out.data_ptr(), *dims,
                slope, int(y.dtype == torch.bfloat16))
    bias_act.launches += 1
    return out


def bias_act_bwd(g: Tensor, out: Optional[Tensor], slope: float, window: Window,
                 y_shape) -> Tuple[Tensor, Tensor]:
    """dL/dy (``y_shape``) and dL/d bias (C, float32) from g = dL/d out;
    ``out`` is read only under an activation (slope != 1)."""
    if g.device.type == "cpu":
        return _bias_act_bwd_reference(g, out, slope, window, y_shape)
    window = _kept(y_shape, window)
    act = slope != 1.0
    # Without an activation or a window, dL/dy is g itself.
    grad_y = g.new_empty(y_shape) if act or window is not None else None
    y_like = grad_y if grad_y is not None else g
    _check(y_like, window)
    dims = _dims(y_like, window)
    n, c, hy, wy, _, _, h, w = dims
    for name, t in (("g", g), ("out", out if act else g)):
        if t.shape != (n, c, h, w) or t.dtype != g.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({n}, {c}, {h}, {w}) {g.dtype}")
    elems = hy * wy if window is not None else h * w
    chunks = -(-elems // _CHUNK_ELEMS())
    partial = torch.empty(n * c * chunks, dtype=torch.float32, device=g.device)
    grad_bias = torch.empty(c, dtype=torch.float32, device=g.device)
    _BWD.launch("bias_act_bwd", g.device, g.data_ptr(), out.data_ptr() if act else None,
                y_like.data_ptr(), partial.data_ptr(), grad_bias.data_ptr(), *dims, slope,
                int(act), int(g.dtype == torch.bfloat16))
    bias_act.launches_bwd += 1
    return y_like, grad_bias


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: Tensor, bias: Tensor, slope: float, window: Window) -> Tensor:
        out = bias_act_fwd(y, bias, slope, window)
        # The identity's backward needs no tensor.
        ctx.save_for_backward(out if slope != 1.0 else None)
        ctx.slope, ctx.window, ctx.y_shape = slope, window, y.shape
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        (out,) = ctx.saved_tensors
        grad_y, grad_bias = bias_act_bwd(g.contiguous(), out, ctx.slope, ctx.window,
                                         ctx.y_shape)
        return grad_y, grad_bias.to(g.dtype), None, None


@launch.counted("launches", "launches_bwd")
def bias_act(y: Tensor, bias: Tensor, slope: float = 1.0, window: Window = None) -> Tensor:
    """``act(y[window] + bias[c])`` as a new contiguous tensor, differentiable
    in y and bias."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return _BiasAct.apply(y, bias, slope, window)
    return bias_act_fwd(y, bias, slope, window)


def conv_bias_act(conv, x: Tensor, weight: Tensor, bias: Tensor, slope: float = 1.0,
                  crop: Tuple[int, int] = (0, 0), **conv_args) -> Tensor:
    """``act(conv(x, weight, bias, **conv_args))`` less its first ``crop`` =
    (rows, columns). On CUDA the convolution runs without its bias (cuDNN
    takes none: ATen would add it in a pass of its own) and ``bias_act``
    adds it with the activation in one pass. Elsewhere the convolution adds
    its own bias, as the CPU's fuses it, and the activation is
    ``leaky_relu``: a plain layer's numbers, bit for bit."""
    top, left = crop
    if x.is_cuda:
        y = conv(x, weight, None, **conv_args)
        h, w = y.shape[-2:]
        return bias_act(y, bias, slope, (top, left, h - top, w - left) if any(crop) else None)
    y = conv(x, weight, bias, **conv_args)[:, :, top:, left:]
    return y if slope == 1.0 else F.leaky_relu(y, slope)
