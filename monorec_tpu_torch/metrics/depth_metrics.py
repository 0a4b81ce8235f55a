"""Sparse depth metrics (``monorec_tpu/metrics/depth_metrics.py:42-53,
89-129``), on NCHW tensors.

Each metric reads inverse depth for both the prediction (``data["result"]``)
and the GT (``data["target"]``), masks invalid GT (gt == 0 or beyond
``max_distance``) and converts both by relu -> clamp_min(1 / max_distance)
-> reciprocal. Signature: ``metric(data, roi, max_distance) -> scalar``.
Only the sparse family is ported so far; the dense, ``_onlyvalid``,
``_onlydynamic``, scale-invariant and completeness metrics come later.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from monorec_tpu_torch.utils import (
    get_absolute_depth,
    get_mask,
    get_positive_depth,
    mask_mean,
    preprocess_roi,
)

Tensor = torch.Tensor


def _prep_sparse(data, roi, max_distance):
    pred, gt = preprocess_roi(data["result"], data["target"], roi)
    mask = get_mask(pred, gt, max_distance=max_distance)
    pred, gt = get_positive_depth(pred, gt)
    pred, gt = get_absolute_depth(pred, gt, max_distance)
    # Masked entries become 1 so ratios and logs stay finite; mask_mean
    # leaves them out of every reduction anyway.
    return torch.where(mask, 1.0, pred), torch.where(mask, 1.0, gt), mask


def _sparse(base):
    def metric(data, roi=None, max_distance=None):
        return base(*_prep_sparse(data, roi, max_distance))

    return metric


def _thresh_ratio(pred, gt):
    return torch.maximum(gt / pred, pred / gt)


def _a_base(t):
    def base(pred, gt, mask):
        ok = (_thresh_ratio(pred, gt) < t).to(pred.dtype)
        return mask_mean(torch.where(mask, 0.0, ok), mask)

    return base


def _rmse_base(pred, gt, mask):
    return torch.sqrt(mask_mean((pred - gt) ** 2, mask, dim=(1, 2, 3))).mean()


def _rmse_log_base(pred, gt, mask):
    return torch.sqrt(mask_mean((torch.log(pred) - torch.log(gt)) ** 2, mask,
                                dim=(1, 2, 3))).mean()


def _abs_rel_base(pred, gt, mask):
    return mask_mean((pred - gt).abs() / gt, mask)


def _sq_rel_base(pred, gt, mask):
    return mask_mean((pred - gt) ** 2 / gt, mask)


METRICS: Dict[str, Callable] = {
    "a1_sparse_metric": _sparse(_a_base(1.25)),
    "a2_sparse_metric": _sparse(_a_base(1.25**2)),
    "a3_sparse_metric": _sparse(_a_base(1.25**3)),
    "rmse_sparse_metric": _sparse(_rmse_base),
    "rmse_log_sparse_metric": _sparse(_rmse_log_base),
    "abs_rel_sparse_metric": _sparse(_abs_rel_base),
    "sq_rel_sparse_metric": _sparse(_sq_rel_base),
}

# Trainers key their logs and the monitor metric on ``fn.__name__``.
for _name, _fn in METRICS.items():
    _fn.__name__ = _name


def get_metric(name: str) -> Callable:
    if name not in METRICS:
        raise KeyError(f"metric '{name}' is not ported yet; ported: {sorted(METRICS)}")
    return METRICS[name]
