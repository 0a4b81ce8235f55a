"""Masked reductions, ROI and depth helpers, median scaling, value faders
(``monorec_tpu/utils/core.py``), on NCHW tensors."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from monorec_tpu_torch.parallel import ratio_of_sums

Tensor = torch.Tensor


def mask_mean(t: Tensor, invalid: Tensor, dim=None) -> Tensor:
    """Mean of ``t`` over entries where ``invalid`` is False.

    The denominator is (element count - #invalid), as in the reference
    (``utils/util.py:110-118``), so an all-invalid reduction divides by zero
    and yields NaN, which callers guard as the reference does. With
    ``dim=None`` it couples the samples: under a sharded batch the sum and
    the count are the global batch's (``parallel.ratio_of_sums``), so a
    shard with no valid entry is NaN only where the global batch is.
    """
    invalid = torch.broadcast_to(invalid, t.shape)
    t = torch.where(invalid, 0.0, t)
    if dim is None:
        return ratio_of_sums(t.sum(), t.numel() - invalid.sum().to(t.dtype))
    dims = tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)
    total = 1
    for d in dims:
        total *= t.shape[d]
    return t.sum(dim=dims) / (total - invalid.sum(dim=dims).to(t.dtype))


def preprocess_roi(pred, gt: Tensor, roi: Optional[Sequence[int]]):
    """Crop NCHW prediction(s) and GT to a region of interest [t, b, l, r]."""
    if roi is None:
        return pred, gt
    t, b, l, r = roi
    crop = lambda x: x[:, :, t:b, l:r]  # noqa: E731
    if isinstance(pred, list):
        return [crop(p) for p in pred], crop(gt)
    return crop(pred), crop(gt)


def get_positive_depth(pred, gt: Tensor):
    if isinstance(pred, list):
        return [torch.relu(p) for p in pred], torch.relu(gt)
    return torch.relu(pred), torch.relu(gt)


def get_absolute_depth(pred, gt: Tensor, max_distance: Optional[float] = None):
    """Inverse depth -> metric depth with an optional far clamp."""
    if max_distance is not None:
        clamp = 1.0 / max_distance
        if isinstance(pred, list):
            pred = [torch.clamp_min(p, clamp) for p in pred]
        else:
            pred = torch.clamp_min(pred, clamp)
        gt = torch.clamp_min(gt, clamp)
    if isinstance(pred, list):
        return [1.0 / p for p in pred], 1.0 / gt
    return 1.0 / pred, 1.0 / gt


def get_mask(pred: Tensor, gt: Tensor, max_distance: Optional[float] = None,
             pred_all_valid: bool = True) -> Tensor:
    """Invalid-pixel mask for sparse metrics (gt == 0, too-far gt, optionally
    pred == 0)."""
    mask = gt == 0
    if max_distance:
        mask = mask | (gt < 1.0 / max_distance)
    if not pred_all_valid:
        mask = mask | (pred == 0)
    return mask


def median_scaling(result: Tensor, target: Tensor) -> Tensor:
    """``result`` scaled per sample by median(target) / median(result), both
    medians over the pixels with target > 0 (``monorec_tpu/utils/core.py``).
    The median is the JAX package's: the mean of the two middle values of
    the sorted valid pixels (one value when their count is odd); a sample
    with no valid pixel gets inf / inf = NaN."""
    b = result.shape[0]
    valid = (target > 0).reshape(b, -1)
    n_valid = valid.sum(1, keepdim=True)
    lo = ((n_valid - 1) // 2).clamp_min(0)
    hi = n_valid // 2

    def masked_median(x):
        s = torch.where(valid, x.reshape(b, -1), torch.inf).sort(dim=1).values
        return (s.gather(1, lo) + s.gather(1, hi)) / 2.0

    ratio = masked_median(target) / masked_median(result)
    return result * ratio.reshape((b,) + (1,) * (result.dim() - 1))


class ValueFader:
    """Piecewise-linear schedule over epochs (reference ``ValueFader``)."""

    def __init__(self, steps: List[float], values: List[float]):
        self.steps = steps
        self.values = values

    def get_value(self, epoch: float) -> float:
        if epoch >= self.steps[-1]:
            return self.values[-1]
        i = 0
        while i < len(self.steps) - 1 and epoch >= self.steps[i + 1]:
            i += 1
        p = (epoch - self.steps[i]) / float(self.steps[i + 1] - self.steps[i])
        return (1 - p) * self.values[i] + p * self.values[i + 1]


def operator_on_dict(d0: Dict, d1: Dict, op, default=0):
    keys = set(d0) | set(d1)
    return {k: op(d0.get(k, default), d1.get(k, default)) for k in keys}
