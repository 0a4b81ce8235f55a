"""Bilinear sampling with the reference's ``grid_sample`` flavor
(``monorec_tpu/ops/sampling.py::bilinear_sample``).

The JAX package re-implements ``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)`` as a gather; in PyTorch that
call *is* the reference semantics. It serves the plain cost-volume path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
