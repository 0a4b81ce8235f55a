"""Plane-sweep SAD scoring: the CUDA kernel K1 and its plain PyTorch version.

``plane_sweep_sad`` is the port of ``monorec_tpu/ops/pallas/cv_kernel.py::
plane_sweep_sad``. On CUDA tensors it launches the hand-written kernel
``cuda/plane_sweep_sad.cu`` (built at first use); on CPU tensors it runs
``plane_sweep_sad_reference``. Nothing else selects between the two, and a
build or launch failure raises.

Contract (``cv_kernel.py:600-662``): for every source image n and
hypothesis d, warp the source by the pixel-unit homography ``homs[n, d]``
(``m22 == 1``, float64 so that M - I keeps its digits; bilinear, zero
padding), warp the border indicator
(``border_radius <= p < size - border_radius``) the same way, score the
warped source against keyframe ``n // frames_per_image`` by ``use_ssim``
(1 SSIM 3x3 uniform window with reflect pad, 2 0.85*SSIM + 0.15*L1, 0 L1,
-1 3x3 zero-padded avg-pooled L1), weight the channels by
``channel_weights`` (already divided by patch_size**2) and take the
zero-padded 3x3 box sum. Returns sad (N, D, H, W), wmask (N, D, H, W) and
coverage (N, D), all float32; coverage is 0 because a gather kernel has
full reach.

The sources may be float32 or bfloat16 (the serving policy's
``cv_warp_dtype``); the kernel converts bf16 to float32 on load, and the
plain version runs on ``images.float()``. Keyframes are float32 either way.
``plane_sweep_sad.launches`` counts launches on float32 sources and
``plane_sweep_sad.launches_bf16`` those on bf16 sources.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from monorec_tpu_torch.ops.ssim import ssim

Tensor = torch.Tensor

DEFAULT_CHANNEL_WEIGHTS = (5 / 32 / 9, 16 / 32 / 9, 11 / 32 / 9)
USE_SSIM_MODES = (1, 2, 0, -1)


def photometric_difference(warped: Tensor, key: Tensor, use_ssim: int) -> Tensor:
    """Per-channel error between (M, C, H, W) warped sources and keyframes
    (``monorec_tpu/ops/cost_volume.py::_photometric_difference``)."""
    if use_ssim == 1:
        return ssim(warped + 0.5, key + 0.5)
    if use_ssim == 2:
        return 0.85 * ssim(warped + 0.5, key + 0.5) + 0.15 * torch.abs(warped - key)
    if use_ssim == 0:
        return torch.abs(warped - key)
    # The reference's "else" branch: 3x3 avg pool with zero padding (/9).
    return F.avg_pool2d(torch.abs(warped - key), 3, stride=1, padding=1)


def box_sum_3x3(x: Tensor) -> Tensor:
    """Zero-padded 3x3 box sum over the trailing two dims."""
    xp = F.pad(x, (1, 1, 1, 1))
    s = xp[..., :-2, :] + xp[..., 1:-1, :] + xp[..., 2:, :]
    return s[..., :-2] + s[..., 1:-1] + s[..., 2:]


def upcast_bf16(t: Tensor) -> Tensor:
    """bf16 -> float32 (exact); other dtypes unchanged."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _displacements(homographies: Tensor, h: int, w: int) -> Tuple[Tensor, Tensor]:
    """Per-pixel displacements (dx, dy), each (N, D, H, W), of p -> M p: the
    kernel's formulation, M - I taken in float64, then float32 (see the
    kernel's "Coordinates" note)."""
    n, d = homographies.shape[:2]
    a = homographies.to(torch.float64).reshape(n, d, 9).clone()
    a[..., 0] -= 1.0
    a[..., 4] -= 1.0
    a = a.to(torch.float32)[..., None, None]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=homographies.device),
        torch.arange(w, dtype=torch.float32, device=homographies.device),
        indexing="ij",
    )
    e = a[:, :, 6] * xs + a[:, :, 7] * ys + 1e-7  # (M p)_z - 1
    dx = (a[:, :, 0] * xs + a[:, :, 1] * ys + a[:, :, 2] - xs * e) / (1.0 + e)
    dy = (a[:, :, 3] * xs + a[:, :, 4] * ys + a[:, :, 5] - ys * e) / (1.0 + e)
    return dx, dy


def _gather_bilinear(
    images: Tensor, dx: Tensor, dy: Tensor, border_radius: int
) -> Tuple[Tensor, Tensor]:
    """Bilinear zero-pad samples of (N, C, H, W) images at p + (dx, dy),
    (N, D, H, W) displacements, and of the border indicator. Taps are summed
    in the kernel's order: (x0,y0), (x1,y0), (x0,y1), (x1,y1)."""
    n, c, h, w = images.shape
    d = dx.shape[1]
    fdx, fdy = torch.floor(dx), torch.floor(dy)
    wx1, wy1 = dx - fdx, dy - fdy
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dx.dtype, device=dx.device),
        torch.arange(w, dtype=dx.dtype, device=dx.device),
        indexing="ij",
    )
    x0, y0 = xs + fdx, ys + fdy
    flat = images.reshape(n, c, h * w)
    warped = torch.zeros(n, c, d * h * w, dtype=images.dtype, device=images.device)
    wmask = torch.zeros_like(dx)
    taps = ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
            (x0, y0 + 1, wx0 * wy1), (x0 + 1, y0 + 1, wx1 * wy1))
    for xi, yi, wt in taps:
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = torch.where(inside, yi * w + xi, 0.0).long().reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, -1))
        warped = warped + torch.where(inside.reshape(n, 1, -1), vals * wt.reshape(n, 1, -1), 0.0)
        interior = (
            (xi >= border_radius) & (xi < w - border_radius)
            & (yi >= border_radius) & (yi < h - border_radius)
        )
        wmask = wmask + torch.where(interior, wt, 0.0)
    return warped.reshape(n, c, d, h, w).transpose(1, 2), wmask


def plane_sweep_sad_reference(
    images: Tensor,
    keyframes: Tensor,
    homographies: Tensor,
    border_radius: int = 2,
    frames_per_image: int = 2,
    use_ssim: int = 1,
    channel_weights: Tuple[float, ...] = DEFAULT_CHANNEL_WEIGHTS,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel, on any device (see module doc)."""
    images = upcast_bf16(images)
    n, c, h, w = images.shape
    d = homographies.shape[1]
    warped, wmask = _gather_bilinear(images, *_displacements(homographies, h, w), border_radius)

    key = keyframes.repeat_interleave(frames_per_image, 0)[:, None].expand(n, d, c, h, w)
    diff = photometric_difference(
        warped.reshape(n * d, c, h, w), key.reshape(n * d, c, h, w), use_ssim
    )
    e = channel_weights[0] * diff[:, 0]
    for ci in range(1, c):
        e = e + channel_weights[ci] * diff[:, ci]
    sad = box_sum_3x3(e).reshape(n, d, h, w)
    return sad, wmask, torch.zeros(n, d, device=images.device)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from monorec_tpu_torch.ops.cuda import build

    lib = build.load("plane_sweep_sad")
    lib.plane_sweep_sad_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    )
    lib.plane_sweep_sad_launch.restype = ctypes.c_int
    lib.plane_sweep_sad_error_string.argtypes = [ctypes.c_int]
    lib.plane_sweep_sad_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(images, keyframes, homographies, frames_per_image, use_ssim,
                         channel_weights) -> None:
    for name, t, dtypes in (("images", images, (torch.float32, torch.bfloat16)),
                            ("keyframes", keyframes, (torch.float32,)),
                            ("homographies", homographies, (torch.float64,))):
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if images.dim() != 4 or images.shape[1] != 3:
        raise ValueError(f"images must be (N, 3, H, W), got {tuple(images.shape)}")
    n, c, h, w = images.shape
    if h < 2 or w < 2 or not 0 < n < 65536:
        raise ValueError(f"unsupported image batch {tuple(images.shape)}")
    if keyframes.shape != (n // frames_per_image, c, h, w) or n % frames_per_image:
        raise ValueError(
            f"keyframes {tuple(keyframes.shape)} do not match {n} images "
            f"at {frames_per_image} frames per keyframe"
        )
    if homographies.dim() != 4 or homographies.shape[0] != n or homographies.shape[2:] != (3, 3):
        raise ValueError(f"homographies must be (N, D, 3, 3), got {tuple(homographies.shape)}")
    if use_ssim not in USE_SSIM_MODES:
        raise ValueError(f"use_ssim must be one of {USE_SSIM_MODES}, got {use_ssim}")
    if len(channel_weights) != c:
        raise ValueError(f"{len(channel_weights)} channel weights for {c} channels")


def plane_sweep_sad(
    images: Tensor,  # (N, C, H, W) float32 or bfloat16 in [-0.5, 0.5]
    keyframes: Tensor,  # (B, C, H, W) float32, N == B * frames_per_image
    homographies: Tensor,  # (N, D, 3, 3) float64, normalized so m22 == 1
    border_radius: int = 2,
    frames_per_image: int = 2,
    use_ssim: int = 1,
    channel_weights: Tuple[float, ...] = DEFAULT_CHANNEL_WEIGHTS,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused plane-sweep scoring; returns (sad, wmask, coverage).

    CUDA tensors launch the kernel, CPU tensors run the plain version.
    ``plane_sweep_sad.launches`` / ``.launches_bf16`` count kernel launches
    on float32 / bf16 sources.
    """
    if images.device.type == "cpu":
        return plane_sweep_sad_reference(
            images, keyframes, homographies, border_radius, frames_per_image,
            use_ssim, channel_weights,
        )
    if not images.is_cuda:
        raise ValueError(f"plane_sweep_sad runs on CUDA or CPU tensors, not {images.device}")
    _check_kernel_inputs(images, keyframes, homographies, frames_per_image, use_ssim,
                         channel_weights)
    n, _, h, w = images.shape
    d = homographies.shape[1]
    bf16 = images.dtype == torch.bfloat16
    lib = _library()
    sad = torch.empty(n, d, h, w, dtype=torch.float32, device=images.device)
    wmask = torch.empty_like(sad)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.plane_sweep_sad_launch(
            images.data_ptr(), keyframes.data_ptr(), homographies.data_ptr(),
            sad.data_ptr(), wmask.data_ptr(), n, d, h, w, frames_per_image,
            border_radius, use_ssim, int(bf16), *(float(x) for x in channel_weights), stream,
        )
    if code != 0:
        msg = lib.plane_sweep_sad_error_string(code).decode()
        raise RuntimeError(f"plane_sweep_sad launch failed: {msg} ({code})")
    if bf16:
        plane_sweep_sad.launches_bf16 += 1
    else:
        plane_sweep_sad.launches += 1
    return sad, wmask, torch.zeros(n, d, device=images.device)


plane_sweep_sad.launches = 0
plane_sweep_sad.launches_bf16 = 0
