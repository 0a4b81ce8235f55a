"""The fused photometric error: the CUDA kernel K3 and its plain version.

``photo_error_fwd`` and ``photo_error_bwd`` are the ports of
``monorec_tpu/ops/pallas/photo_error.py``'s two kernels. On CUDA tensors
each launches its kernel of ``cuda/photo_error.cu`` (built at first use);
on CPU tensors it runs the plain version. Nothing else selects between the
two, and a build or launch failure raises.

Contract: x, y (M, C, H, W) float32 -> (M, H, W) float32,
``0.85 * mean_c(SSIM) + 0.15 * mean_c(|x - y|)`` with the SSIM of
``ops/ssim.py`` at ``pad_reflection=False, gaussian_average=True,
comp_mode=True`` (zero padding, the reference's 3x3 gaussian window,
``clamp(1 - n/d, 0, 1) / 2``). The backward is the gradient with respect to
x only; y, the keyframe, is data. The clamp's subgradient is inclusive
(0 <= v <= 1), and ``|x - y|`` differentiates to ``sign(x - y)`` with
sign(0) = 0.

``photo_error`` is the differentiable error (the JAX package's custom VJP
``photo_error``): the forward saves x and y, the backward launches the
backward kernel and gives y no gradient, on every device.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from monorec_tpu_torch.ops.ssim import ssim

Tensor = torch.Tensor


def photo_error_reference(x: Tensor, y: Tensor) -> Tensor:
    """Plain version: ``compute_errors`` of the reference on (..., C, H, W)
    inputs, differentiable by autograd in both."""
    lead, (c, h, w) = x.shape[:-3], x.shape[-3:]
    x4, y4 = x.reshape(-1, c, h, w), y.reshape(-1, c, h, w)
    s = ssim(x4, y4, pad_reflection=False, gaussian_average=True, comp_mode=True)
    out = 0.85 * s.mean(1) + 0.15 * (x4 - y4).abs().mean(1)
    return out.reshape(*lead, h, w)


def _photo_error_bwd_reference(x: Tensor, y: Tensor, cot: Tensor) -> Tensor:
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        (gx,) = torch.autograd.grad(photo_error_reference(xg, y.detach()), xg, cot)
    return gx


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from monorec_tpu_torch.ops.cuda import build

    lib = build.load("photo_error")
    lib.photo_error_fwd_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.photo_error_fwd_launch.restype = ctypes.c_int
    lib.photo_error_bwd_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.photo_error_bwd_launch.restype = ctypes.c_int
    lib.photo_error_error_string.argtypes = [ctypes.c_int]
    lib.photo_error_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: Tensor, y: Tensor, cot=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"photo_error runs on CUDA or CPU tensors, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (M, C, H, W), got {tuple(x.shape)}")
    m, c, h, w = x.shape
    if not (0 < m <= 65535 and min(c, h, w) > 0):
        raise ValueError(f"unsupported image batch {tuple(x.shape)}")
    named = [("x", x, (m, c, h, w)), ("y", y, (m, c, h, w))]
    if cot is not None:
        named.append(("cot", cot, (m, h, w)))
    for name, t, shape in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code != 0:
        msg = lib.photo_error_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({code})")


def photo_error_fwd(x: Tensor, y: Tensor) -> Tensor:
    """Error map (M, H, W). CUDA tensors launch the kernel, CPU tensors run
    the plain version; ``photo_error_fwd.launches`` counts kernel launches,
    and ``.launches_by_batch`` (a Counter) counts them by M."""
    if x.device.type == "cpu":
        return photo_error_reference(x, y)
    _check(x, y)
    m, c, h, w = x.shape
    out = torch.empty(m, h, w, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.photo_error_fwd_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                          m, c, h, w, stream)
    _raise_on(code, lib, "photo_error_fwd")
    photo_error_fwd.launches += 1
    photo_error_fwd.launches_by_batch[m] += 1
    return out


def photo_error_bwd(x: Tensor, y: Tensor, cot: Tensor) -> Tensor:
    """d sum(photo_error_fwd(x, y) * cot) / dx, (M, C, H, W).
    ``photo_error_bwd.launches`` counts kernel launches, and
    ``.launches_by_batch`` (a Counter) counts them by M."""
    if x.device.type == "cpu":
        return _photo_error_bwd_reference(x, y, cot)
    _check(x, y, cot)
    m, c, h, w = x.shape
    gx = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.photo_error_bwd_launch(x.data_ptr(), y.data_ptr(), cot.data_ptr(),
                                          gx.data_ptr(), m, c, h, w, stream)
    _raise_on(code, lib, "photo_error_bwd")
    photo_error_bwd.launches += 1
    photo_error_bwd.launches_by_batch[m] += 1
    return gx


for _entry in (photo_error_fwd, photo_error_bwd):
    _entry.launches = 0
    _entry.launches_by_batch = collections.Counter()


class _PhotoError(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, y: Tensor) -> Tensor:
        ctx.save_for_backward(x, y)
        return photo_error_fwd(x, y)

    @staticmethod
    def backward(ctx, cot: Tensor):
        x, y = ctx.saved_tensors
        return photo_error_bwd(x, y, cot.contiguous()), None


def photo_error(x: Tensor, y: Tensor) -> Tensor:
    """Differentiable fused error of (M, C, H, W) ``x`` against ``y``:
    gradients reach x, never y."""
    return _PhotoError.apply(x.contiguous(), y.detach().contiguous())
