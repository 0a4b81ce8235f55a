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
zero-padded 3x3 box sum. Returns sad (N, D, H, W) and wmask (N, D, H, W),
both float32. The TPU kernel's coverage count has no counterpart: a gather
has full reach.

The sources may be float32 or bfloat16 (the serving policy's
``cv_warp_dtype``); the kernel converts bf16 to float32 on load, and the
plain version runs on ``images.float()``. Keyframes are float32 either way.
``plane_sweep_sad.launches`` counts launches on float32 sources and
``plane_sweep_sad.launches_bf16`` those on bf16 sources.

``plane_sweep_cost_volume`` is the same kernel with the cost volume's
scoring folded in (``monorec_tpu/ops/cost_volume.py::_score_and_fuse``,
``score_and_fuse`` here): it returns the fused (B, D, H, W) and per-frame
(B, F, D, H, W) cost volumes and has no SAD or warped-border-indicator
outputs (the SADs wait in the per-frame CV's buffer, which the scoring
overwrites). Its plain version is
``plane_sweep_cost_volume_reference``: ``plane_sweep_sad_reference``, the
validity mask, then ``score_and_fuse``. It counts on its own
``.launches`` / ``.launches_bf16``; a launch is the kernel and its frame
fusion together. With ``groups``, a partition of each keyframe's frames into
consecutive runs (``monorec_tpu/ops/cost_volume.py::_plane_sweep_sad_grouped``),
one launch sweeps every frame and fuses each group into a cost volume of its
own; per-frame work never mixes frames, so each group's result equals a
launch over its frames alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from monorec_tpu_torch.ops.cuda import launch
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
) -> Tuple[Tensor, Tensor]:
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
    return sad, wmask


def valid_pixels(wmask: Tensor, border_radius: int) -> Tensor:
    """(N, H, W) 1.0 where a pixel is interior and its warped border
    indicator (N, D, H, W) is non-zero at every hypothesis, else 0.0
    (reference ``monorec_model.py:219``)."""
    h, w = wmask.shape[-2:]
    r = border_radius
    valid = (wmask != 0).all(dim=1).to(torch.float32)
    interior = torch.zeros(h, w, dtype=torch.float32, device=wmask.device)
    interior[r : h - r, r : w - r] = 1.0
    return valid * interior


def score_and_fuse(sad: Tensor, valid: Tensor, alpha: float = 10.0,
                   not_center_cv: bool = False) -> Tuple[Tensor, Tensor]:
    """Frame fusion (reference ``monorec_model.py:250-269``) of SADs
    (B, F, D, H, W) with the validity (B, F, H, W); returns fused
    (B, D, H, W) and per-frame CVs (B, F, D, H, W)."""
    d_steps = sad.shape[2]
    sfcv = (1.0 - 2.0 * sad) * valid[:, :, None]
    sharp = torch.exp(-alpha * (sad - sad.amin(dim=2, keepdim=True)) ** 2)
    # A frame whose hypotheses all score alike (a flat cost curve) gets a
    # weight ~1e-5 that depends on the squares of SAD differences ~1e-3, so
    # float32 rounding of the SADs moves the fused CV at such pixels by up to
    # ~2e-4 (256x512, D=32, against float64); the per-frame CVs do not mix.
    weight = (1.0 - (sharp.sum(dim=2) - 1.0) / (d_steps - 1)) * valid  # (B, F, H, W)
    weight_sum = weight.sum(dim=1)  # (B, H, W)
    fused = (sad * weight[:, :, None]).sum(dim=1)  # (B, D, H, W)
    nonzero = (weight_sum > 0)[:, None]
    fused = torch.where(nonzero, fused / torch.where(nonzero, weight_sum[:, None], 1.0), fused)
    if not not_center_cv:
        fused = 1.0 - 2.0 * fused
    return torch.where(nonzero, fused, 0.0), sfcv


def _group_slices(groups, frames_per_image: int):
    """The frame slices of ``groups`` (None: one group of every frame),
    checked to partition the ``frames_per_image`` frames of a keyframe."""
    groups = (frames_per_image,) if groups is None else tuple(int(g) for g in groups)
    if not groups or min(groups) <= 0 or sum(groups) != frames_per_image:
        raise ValueError(f"groups {groups} do not partition {frames_per_image} frames")
    starts = [sum(groups[:i]) for i in range(len(groups))]
    return [slice(f0, f0 + fg) for f0, fg in zip(starts, groups)]


def plane_sweep_cost_volume_reference(
    images: Tensor,
    keyframes: Tensor,
    homographies: Tensor,
    border_radius: int = 2,
    frames_per_image: int = 2,
    use_ssim: int = 1,
    channel_weights: Tuple[float, ...] = DEFAULT_CHANNEL_WEIGHTS,
    alpha: float = 10.0,
    not_center_cv: bool = False,
    groups: Optional[Sequence[int]] = None,
):
    """Plain version of ``plane_sweep_cost_volume``, on any device; runs in
    the keyframes' dtype (float64 keyframes and sources give the exact
    scoring of the kernel's float32 displacements)."""
    slices = _group_slices(groups, frames_per_image)
    sad, wmask = plane_sweep_sad_reference(images, keyframes, homographies, border_radius,
                                           frames_per_image, use_ssim, channel_weights)
    n, d, h, w = sad.shape
    b, f = n // frames_per_image, frames_per_image
    valid = valid_pixels(wmask, border_radius).to(sad.dtype).reshape(b, f, h, w)
    sad = sad.reshape(b, f, d, h, w)
    # Each group scored on its own contiguous copy, as a call over its frames
    # alone would be.
    outs = [score_and_fuse(sad[:, g].contiguous(), valid[:, g].contiguous(), alpha,
                           not_center_cv) for g in slices]
    return outs[0] if groups is None else outs


_SAD = launch.Entry(
    "plane_sweep_sad", "plane_sweep_sad_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
_COST_VOLUME = launch.Entry(
    "plane_sweep_sad", "plane_sweep_cost_volume_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int] + [ctypes.c_float] * 3
    + [ctypes.c_void_p])


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


def _texels(images: Tensor) -> Tensor:
    """The kernel's scratch for the sources interleaved per pixel: (N, H, W,
    4) in the sources' dtype, one 16-byte (float32) or 8-byte (bf16) word."""
    n, _, h, w = images.shape
    return torch.empty(n, h, w, 4, dtype=images.dtype, device=images.device)


@launch.counted("launches", "launches_bf16")
def plane_sweep_sad(
    images: Tensor,  # (N, C, H, W) float32 or bfloat16 in [-0.5, 0.5]
    keyframes: Tensor,  # (B, C, H, W) float32, N == B * frames_per_image
    homographies: Tensor,  # (N, D, 3, 3) float64, normalized so m22 == 1
    border_radius: int = 2,
    frames_per_image: int = 2,
    use_ssim: int = 1,
    channel_weights: Tuple[float, ...] = DEFAULT_CHANNEL_WEIGHTS,
) -> Tuple[Tensor, Tensor]:
    """Fused plane-sweep scoring; returns (sad, wmask).

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
    sad = torch.empty(n, d, h, w, dtype=torch.float32, device=images.device)
    wmask = torch.empty_like(sad)
    texels = _texels(images)
    _SAD.launch(
        "plane_sweep_sad", images.device, images.data_ptr(), keyframes.data_ptr(),
        homographies.data_ptr(), texels.data_ptr(), sad.data_ptr(), wmask.data_ptr(), n, d, h, w,
        frames_per_image, border_radius, use_ssim, int(bf16),
        *(float(x) for x in channel_weights),
    )
    if bf16:
        plane_sweep_sad.launches_bf16 += 1
    else:
        plane_sweep_sad.launches += 1
    return sad, wmask


@launch.counted("launches", "launches_bf16")
def plane_sweep_cost_volume(
    images: Tensor,  # (N, C, H, W) float32 or bfloat16 in [-0.5, 0.5]
    keyframes: Tensor,  # (B, C, H, W) float32, N == B * frames_per_image
    homographies: Tensor,  # (N, D, 3, 3) float64, normalized so m22 == 1
    border_radius: int = 2,
    frames_per_image: int = 2,
    use_ssim: int = 1,
    channel_weights: Tuple[float, ...] = DEFAULT_CHANNEL_WEIGHTS,
    alpha: float = 10.0,
    not_center_cv: bool = False,
    groups: Optional[Sequence[int]] = None,
):
    """Fused plane-sweep cost volume; returns fused (B, D, H, W) and the
    per-frame CVs (B, F, D, H, W), float32. With ``groups`` (frame counts
    that sum to ``frames_per_image``, in order along the frame axis) it
    returns ``[(fused, per-frame CVs) per group]`` from the same one launch;
    the groups' per-frame CVs are views of one (B, F, D, H, W) buffer.

    CUDA tensors launch the kernel (its scoring epilogue, then the frame
    fusion of each group), CPU tensors run the plain version.
    ``plane_sweep_cost_volume.launches`` / ``.launches_bf16`` count kernel
    launches on float32 / bf16 sources.
    """
    if images.device.type == "cpu":
        return plane_sweep_cost_volume_reference(
            images, keyframes, homographies, border_radius, frames_per_image, use_ssim,
            channel_weights, alpha, not_center_cv, groups,
        )
    if not images.is_cuda:
        raise ValueError(
            f"plane_sweep_cost_volume runs on CUDA or CPU tensors, not {images.device}")
    _check_kernel_inputs(images, keyframes, homographies, frames_per_image, use_ssim,
                         channel_weights)
    slices = _group_slices(groups, frames_per_image)
    n, _, h, w = images.shape
    d = homographies.shape[1]
    b = n // frames_per_image
    bf16 = images.dtype == torch.bfloat16
    sfcv = torch.empty(b, frames_per_image, d, h, w, dtype=torch.float32, device=images.device)
    weight = torch.empty(n, h, w, dtype=torch.float32, device=images.device)
    fused = torch.empty(len(slices), b, d, h, w, dtype=torch.float32, device=images.device)
    texels = _texels(images)
    sizes = (ctypes.c_int * len(slices))(*(g.stop - g.start for g in slices))
    _COST_VOLUME.launch(
        "plane_sweep_cost_volume", images.device, images.data_ptr(), keyframes.data_ptr(),
        homographies.data_ptr(), texels.data_ptr(), sfcv.data_ptr(), weight.data_ptr(),
        fused.data_ptr(), n, d, h, w, frames_per_image, len(slices), sizes, border_radius,
        use_ssim, int(bf16), float(alpha), int(not not_center_cv),
        *(float(x) for x in channel_weights),
    )
    if bf16:
        plane_sweep_cost_volume.launches_bf16 += 1
    else:
        plane_sweep_cost_volume.launches += 1
    outs = [(fused[i], sfcv[:, g]) for i, g in enumerate(slices)]
    return outs[0] if groups is None else outs
