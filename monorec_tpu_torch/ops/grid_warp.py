"""The loss warp: the CUDA kernel K2 and its plain PyTorch version.

``grid_warp``, ``grid_warp_jac`` and ``grid_warp_grad`` are the ports of
``monorec_tpu/ops/pallas/grid_warp.py``'s three entry points. On CUDA
tensors each launches the hand-written kernel ``cuda/grid_warp.cu`` (built
at first use) in its mode; on CPU tensors it runs the plain version. Nothing
else selects between the two, and a build or launch failure raises.

Contract: bilinear samples of images (N, C, H, W) at absolute pixel
coordinates xs, ys (each (N, H, W), align_corners=False units), with zero
padding: taps at floor(x), floor(x) + 1 (and in y) with weights
``wx1 = x - floor(x)``; a tap outside 0 <= xi <= W-1, 0 <= yi <= H-1 reads
zero, so a sample whose four taps are all outside is exactly 0.0. The
Jacobian follows the reference subgradient (``grid_warp.py::_hat_grad``):
at an integer fraction d out/dx = I[x0 + 1] - I[x0]. Unlike the TPU
kernel's, these return no coverage: a gather has full reach.

The images may be float32 or bfloat16 (the serving policy's loss-warp
dtype); the kernel converts bf16 on load and the plain versions run on
``images.float()``. Coordinates, cotangents and all outputs are float32.
Each entry point counts its launches on float32 images in ``.launches``
(and by N in the Counter ``.launches_by_batch``) and on bf16 images in
``.launches_bf16``.

``warp_pixels`` is the differentiable warp (``ops/sampling.py::
_grid_sample_tpu`` in the JAX package): its forward runs the Jacobian mode
when a coordinate needs a gradient and keeps the Jacobian for the backward,
which contracts it with the cotangent. The images are data and get no
gradient.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from monorec_tpu_torch.ops.cuda import launch
from monorec_tpu_torch.ops.plane_sweep import upcast_bf16

Tensor = torch.Tensor

_VALUES, _JACOBIAN, _GRADIENT = 0, 1, 2


def _taps(images: Tensor, xs: Tensor, ys: Tensor):
    """The four taps' values (each (N, C, H, W), zero outside) and the
    weights' factors, in the kernel's order (x0,y0), (x1,y0), (x0,y1),
    (x1,y1)."""
    images = upcast_bf16(images)
    n, c, h, w = images.shape
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx1, wy1 = xs - x0, ys - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = images.reshape(n, c, h * w)

    def tap(xi, yi):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = torch.where(inside, yi * w + xi, 0.0).long().reshape(n, 1, h * w)
        vals = torch.gather(flat, 2, idx.expand(n, c, h * w)).reshape(n, c, h, w)
        return vals * inside[:, None]

    v = (tap(x0, y0), tap(x0 + 1, y0), tap(x0, y0 + 1), tap(x0 + 1, y0 + 1))
    return v, (wx0[:, None], wx1[:, None], wy0[:, None], wy1[:, None])


def _interpolate(v, w) -> Tensor:
    (v00, v10, v01, v11), (wx0, wx1, wy0, wy1) = v, w
    return v00 * (wx0 * wy0) + v10 * (wx1 * wy0) + v01 * (wx0 * wy1) + v11 * (wx1 * wy1)


def grid_warp_reference(images: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
    """Plain version of the values mode: the explicit floor gather of the JAX
    XLA path (``monorec_tpu/ops/sampling.py::bilinear_sample``) in pixel
    coordinates, differentiable by autograd in ``xs`` and ``ys``."""
    return _interpolate(*_taps(images, xs, ys))


def grid_warp_jac_reference(images: Tensor, xs: Tensor, ys: Tensor
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the Jacobian mode: (out, d out/d xs, d out/d ys)."""
    v, w = _taps(images, xs, ys)
    (v00, v10, v01, v11), (wx0, wx1, wy0, wy1) = v, w
    out = _interpolate(v, w)
    jx = (v10 - v00) * wy0 + (v11 - v01) * wy1
    jy = (v01 - v00) * wx0 + (v11 - v10) * wx1
    return out, jx, jy


def grid_warp_grad_reference(images: Tensor, xs: Tensor, ys: Tensor, cot: Tensor
                             ) -> Tuple[Tensor, Tensor]:
    """Plain version of the gradient mode: autograd of sum(warp * cot)."""
    with torch.enable_grad():
        x = xs.detach().requires_grad_()
        y = ys.detach().requires_grad_()
        out = grid_warp_reference(images.detach(), x, y)
        gx, gy = torch.autograd.grad(out, (x, y), cot)
    return gx, gy


_LAUNCH = launch.Entry("grid_warp", "grid_warp_launch",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check(images: Tensor, xs: Tensor, ys: Tensor, cot=None) -> None:
    if not images.is_cuda:
        raise ValueError(f"grid_warp runs on CUDA or CPU tensors, not {images.device}")
    if images.dim() != 4:
        raise ValueError(f"images must be (N, C, H, W), got {tuple(images.shape)}")
    n, c, h, w = images.shape
    f32 = (torch.float32,)
    named = [("images", images, (n, c, h, w), (torch.float32, torch.bfloat16)),
             ("xs", xs, (n, h, w), f32), ("ys", ys, (n, h, w), f32)]
    if cot is not None:
        named.append(("cot", cot, (n, c, h, w), f32))
    for name, t, shape, dtypes in named:
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(n, c, h, w) < 1:
        raise ValueError(f"empty image batch {tuple(images.shape)}")


def _launch(entry, mode: int, images: Tensor, xs: Tensor, ys: Tensor, cot, out, jx, jy) -> None:
    """Launch mode ``mode`` and count it on ``entry``, the public wrapper."""
    n, c, h, w = images.shape
    bf16 = images.dtype == torch.bfloat16
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _LAUNCH.launch(entry.__name__, images.device, ptr(images), ptr(xs), ptr(ys), ptr(cot),
                   ptr(out), ptr(jx), ptr(jy), n, c, h, w, mode, int(bf16))
    if bf16:
        entry.launches_bf16 += 1
    else:
        entry.launches += 1
        entry.launches_by_batch[n] += 1


def _empty_f32(images: Tensor) -> Tensor:
    return torch.empty(images.shape, dtype=torch.float32, device=images.device)


@launch.counted("launches", "launches_bf16", "launches_by_batch")
def grid_warp(images: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
    """Warped images (N, C, H, W), float32. CUDA tensors launch the kernel,
    CPU tensors run the plain version; ``grid_warp.launches`` /
    ``.launches_bf16`` count kernel launches."""
    if images.device.type == "cpu":
        return grid_warp_reference(images, xs, ys)
    _check(images, xs, ys)
    out = _empty_f32(images)
    _launch(grid_warp, _VALUES, images, xs, ys, None, out, None, None)
    return out


@launch.counted("launches", "launches_bf16", "launches_by_batch")
def grid_warp_jac(images: Tensor, xs: Tensor, ys: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """(out, d out/d xs, d out/d ys), each (N, C, H, W) float32, from one
    pass. ``grid_warp_jac.launches`` / ``.launches_bf16`` count kernel
    launches."""
    if images.device.type == "cpu":
        return grid_warp_jac_reference(images, xs, ys)
    _check(images, xs, ys)
    out, jx, jy = (_empty_f32(images) for _ in range(3))
    _launch(grid_warp_jac, _JACOBIAN, images, xs, ys, None, out, jx, jy)
    return out, jx, jy


@launch.counted("launches", "launches_bf16", "launches_by_batch")
def grid_warp_grad(images: Tensor, xs: Tensor, ys: Tensor, cot: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """Coordinate gradient (d/d xs, d/d ys), each (N, H, W), of
    sum(grid_warp(images, xs, ys) * cot). ``grid_warp_grad.launches`` /
    ``.launches_bf16`` count kernel launches."""
    if images.device.type == "cpu":
        return grid_warp_grad_reference(images, xs, ys, cot)
    _check(images, xs, ys, cot)
    n, _, h, w = images.shape
    g = torch.empty(n, 2, h, w, dtype=torch.float32, device=images.device)
    _launch(grid_warp_grad, _GRADIENT, images, xs, ys, cot, g, None, None)
    return g[:, 0], g[:, 1]


class _WarpPixels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            out, jx, jy = grid_warp_jac(images, xs, ys)
            ctx.save_for_backward(jx, jy)
        else:
            out = grid_warp(images, xs, ys)
        return out

    @staticmethod
    def backward(ctx, cot: Tensor):
        jx, jy = ctx.saved_tensors
        return None, (cot * jx).sum(1), (cot * jy).sum(1)


def warp_pixels(images: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
    """Differentiable warp of (N, C, H, W) ``images`` at absolute pixel
    coordinates ``xs``, ``ys`` (N, H, W): gradients reach the coordinates,
    never the images."""
    return _WarpPixels.apply(images.detach().contiguous(), xs.contiguous(), ys.contiguous())
