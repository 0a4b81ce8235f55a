"""Training-time augmentation (``monorec_tpu/models/augmentation.py:33-42``):
the depth augmentation's per-sample horizontal flip, on NCHW tensors.

The reference's ``DepthAugmentation`` flips the keyframe, the cost volumes
and the masks of a random half of the batch, and flips every prediction back
(a flip is its own inverse). The flip decisions come from an explicit
``torch.Generator``. The mask augmentation (flip + resized crop) comes with
a later port slice.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def sample_flip_conditions(generator: torch.Generator, batch_size: int) -> Tensor:
    """Per-sample flip decisions (B,) bool, each with probability 0.5, drawn
    on the CPU from ``generator``."""
    return torch.rand(batch_size, generator=generator) < 0.5


def conditional_hflip(x: Tensor, conditions: Tensor) -> Tensor:
    """Flip the samples of (B, ..., H, W) ``x`` along W where ``conditions``."""
    cond = conditions.to(x.device).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(cond, x.flip(-1), x)
