"""Training-time augmentation (``monorec_tpu/models/augmentation.py``) on
NCHW tensors, with every random draw from an explicit ``torch.Generator``.

* The depth augmentation (``DepthAugmentation`` in the reference): a
  per-sample horizontal flip of the keyframe, the cost volumes and the
  masks, and the same flip of every prediction to revert it (a flip is its
  own inverse).
* The mask augmentation (``MaskAugmentation``, kornia's
  RandomHorizontalFlip + RandomResizedCrop with scale 0.8-1 and ratio
  1.9-2.1): one flip and one crop rectangle per sample, applied alike to
  every tensor of the sample and resized back to its own resolution. The
  crop samples through the kernel K2 (``ops/sampling.py::
  grid_sample_planar``), which gives the sampled tensor no gradient. That is
  exact only because every cropped tensor is data or a cost volume computed
  without a gradient; ``apply_mask_aug`` refuses a tensor that requires one
  where autograd would record the crop.

The colour jitter of the JAX package (``jitter_image_keys``) is not ported
yet (ROADMAP item 15).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monorec_tpu_torch.ops.sampling import grid_sample_planar

Tensor = torch.Tensor


def sample_flip_conditions(generator: torch.Generator, batch_size: int) -> Tensor:
    """Per-sample flip decisions (B,) bool, each with probability 0.5, drawn
    on the CPU from ``generator``."""
    return torch.rand(batch_size, generator=generator) < 0.5


def conditional_hflip(x: Tensor, conditions: Tensor) -> Tensor:
    """Flip the samples of (B, ..., H, W) ``x`` along W where ``conditions``."""
    cond = conditions.to(x.device).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(cond, x.flip(-1), x)


class MaskAugParams(NamedTuple):
    """One flip and one crop rectangle per sample, each (B,); the rectangle's
    top-left corner and size in source pixels."""

    flip: Tensor
    y0: Tensor
    x0: Tensor
    crop_h: Tensor
    crop_w: Tensor

    def to(self, device) -> "MaskAugParams":
        return MaskAugParams(*(p.to(device) for p in self))


def sample_mask_aug_params(generator: torch.Generator, batch_size: int, height: int,
                           width: int) -> MaskAugParams:
    """Random flip and resized-crop parameters (scale 0.8-1, ratio 1.9-2.1),
    float32, drawn on the CPU from ``generator``."""
    flip = torch.rand(batch_size, generator=generator) < 0.5
    scale = 0.8 + 0.2 * torch.rand(batch_size, generator=generator)
    ratio = 1.9 + 0.2 * torch.rand(batch_size, generator=generator)
    area = scale * height * width
    crop_w = torch.clamp(torch.sqrt(area * ratio), 1.0, width)
    crop_h = torch.clamp(torch.sqrt(area / ratio), 1.0, height)
    u = torch.rand(batch_size, 2, generator=generator)
    y0 = u[:, 0] * (height - crop_h)
    x0 = u[:, 1] * (width - crop_w)
    return MaskAugParams(flip, y0, x0, crop_h, crop_w)


def crop_grid(params: MaskAugParams, h: int, w: int) -> Tensor:
    """The normalized sampling grid (N, H, W, 2) of the crops, the JAX
    package's: output pixel (i, j) samples its crop at the align_corners=False
    centre y = y0 + (i + 0.5) / H * crop_h - 0.5 (x alike)."""
    n, device = params.y0.shape[0], params.y0.device
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    gy = params.y0[:, None] + ys[None, :] * params.crop_h[:, None]  # (N, H)
    gx = params.x0[:, None] + xs[None, :] * params.crop_w[:, None]  # (N, W)
    ny = (2.0 * gy) / h - 1.0
    nx = (2.0 * gx) / w - 1.0
    return torch.stack([nx[:, None, :].expand(n, h, w), ny[:, :, None].expand(n, h, w)], -1)


def apply_mask_aug(x: Tensor, params: MaskAugParams) -> Tensor:
    """Flip, then crop and resize (N, C, H, W) ``x`` back to (H, W): bilinear
    samples with zero padding at ``crop_grid``."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("apply_mask_aug samples through K2, which gives its input no "
                         "gradient: crop data or cost volumes computed without one")
    params = params.to(x.device)
    x = conditional_hflip(x, params.flip)
    return grid_sample_planar(x.contiguous(), crop_grid(params, *x.shape[-2:]))


def apply_mask_aug_frames(x: Tensor, params: MaskAugParams) -> Tensor:
    """``apply_mask_aug`` on (B, F, C, H, W) stacks: the frame axis folds into
    the batch, each sample's parameters repeated F times (one launch)."""
    b, f = x.shape[:2]
    rep = MaskAugParams(*(p.repeat_interleave(f, 0) for p in params))
    return apply_mask_aug(x.reshape((b * f,) + x.shape[2:]), rep).reshape(x.shape)
