"""Residual image (``monorec_tpu/ops/residual_image.py``): the smallest SSIM
error over the source frames of their depth-warped reprojections.

The reference ``ResidualImageModule`` (``model/layers.py:161-217``): warp
every source frame onto the keyframe by the predicted depth, score it with
the reflection-padded SSIM of ``ops/ssim.py`` (not K3's zero-padded error),
mark pixels out of view as infinite, take the channel mean and the minimum
over frames, and zero the pixels that no frame sees. A cue for moving
objects and for looking at a prediction.
"""

from __future__ import annotations

from typing import Dict

import torch

from monorec_tpu_torch.losses.common import _gather_frames, _warp_by_depth_planar
from monorec_tpu_torch.ops.ssim import ssim

Tensor = torch.Tensor


def residual_image(data: Dict, inv_depth: Tensor, use_mono: bool = True,
                   use_stereo: bool = False) -> Tensor:
    """(B, 1, H, W) residual image of the (B, 1, H, W) inverse depth.

    The frames are warped through the loss warp K2 (``grid_sample_planar``)
    shifted by +1, so a pixel is out of view where any channel of its warp
    is exactly 0, as in the reference."""
    keyframe = data["keyframe"]
    b, c, h, w = keyframe.shape
    frames, poses, intrinsics = _gather_frames(data, use_mono, use_stereo)
    f = frames.shape[1]
    warped = _warp_by_depth_planar(1.0 / inv_depth[:, 0], frames, poses, intrinsics,
                                   data["keyframe_pose"], data["keyframe_intrinsics"], add=1.0)
    invalid = (warped == 0).any(2)  # (B, F, H, W)
    warped = warped - 0.5
    key = (keyframe + 0.5)[:, None].expand_as(warped)
    res = ssim(warped.reshape(b * f, c, h, w), key.reshape(b * f, c, h, w)).reshape(b, f, c, h, w)
    res = torch.where(invalid[:, :, None], float("inf"), res)
    res = res.mean(2).amin(1)  # (B, H, W)
    return torch.where(invalid.all(1), 0.0, res)[:, None]
