"""Bilinear sampling with the reference's ``grid_sample`` flavor
(``monorec_tpu/ops/sampling.py``).

``bilinear_sample``: the JAX package re-implements
``F.grid_sample(mode="bilinear", padding_mode="zeros", align_corners=False)``
as a gather; in PyTorch that call *is* the reference semantics. It serves
the plain cost-volume path.

``grid_sample_planar``: the loss warp, through the kernel K2. The JAX
package's channel-group fold (a TPU VMEM workaround) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from monorec_tpu_torch.ops.grid_warp import warp_pixels

Tensor = torch.Tensor


def bilinear_sample(image: Tensor, grid: Tensor) -> Tensor:
    """Sample images at normalized grid locations.

    Args:
      image: (N, C, H, W) source images.
      grid: (N, Ho, Wo, 2) normalized (x, y) coordinates in [-1, 1].

    Returns:
      (N, C, Ho, Wo) samples; out-of-bounds taps contribute zero.
    """
    return F.grid_sample(
        image, grid, mode="bilinear", padding_mode="zeros", align_corners=False
    )


def _unnormalize(coord: Tensor, size: int) -> Tensor:
    return ((coord + 1.0) * size - 1.0) / 2.0


def pixel_coordinates(grids: Tensor, height: int, width: int):
    """(N, H, W, 2) normalized grids -> the absolute pixel coordinates
    (xs, ys), each (N, H, W), that the loss warp samples at: unnormalized
    (align_corners=False) and clamped to [-3, size + 2], where every tap is
    outside the image (``monorec_tpu/ops/sampling.py:181-182``)."""
    xs = torch.clamp(_unnormalize(grids[..., 0], width), -3.0, width + 2.0)
    ys = torch.clamp(_unnormalize(grids[..., 1], height), -3.0, height + 2.0)
    return xs.contiguous(), ys.contiguous()


def grid_sample_planar(images: Tensor, grids: Tensor,
                       kernel_dtype: Optional[torch.dtype] = None) -> Tensor:
    """Batched sampler in planar layout: images (N, C, H, W), grids
    (N, H, W, 2) -> (N, C, H, W) (``monorec_tpu/ops/sampling.py::
    grid_sample_planar`` on its kernel path). Samples through the loss-warp
    kernel K2 (``ops/grid_warp.py``), whose coordinate gradient is analytic;
    the images get no gradient. ``kernel_dtype`` (None = float32, or
    ``torch.bfloat16``: the serving policy) quantizes the source values
    before K2; the warp accumulates in float32 and returns in the images'
    dtype."""
    n, _, h, w = images.shape
    if grids.shape != (n, h, w, 2):
        raise ValueError(f"grids must be {(n, h, w, 2)}, got {tuple(grids.shape)}")
    kdtype = torch.float32 if kernel_dtype is None else kernel_dtype
    xs, ys = pixel_coordinates(grids.to(torch.float32), h, w)
    return warp_pixels(images.to(kdtype), xs, ys).to(images.dtype)
