"""Depth metrics (``monorec_tpu/metrics/depth_metrics.py``), on NCHW tensors:
all 33 names of the JAX package.

* the dense a1/a2/a3, rmse, rmse_log, abs_rel and sq_rel over every pixel;
* their ``_sparse`` variants, which leave out invalid GT (gt == 0 or beyond
  ``max_distance``), with the ``_sparse_onlyvalid`` family (also pred == 0
  left out) and the ``_sparse_onlydynamic`` family (only the pixels of
  ``data["mvobj_mask"]``);
* sc_inv, l1_rel and l1_inv over every pixel, and completeness and
  covered_gt.

Each metric reads inverse depth for both the prediction (``data["result"]``)
and the GT (``data["target"]``) and converts both by relu ->
clamp_min(1 / max_distance) -> reciprocal. Signature: ``metric(data, roi,
max_distance) -> scalar``; ``METRIC_INPUTS`` names every key a metric
reads (what a data-parallel run gathers from its ranks).
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

METRIC_INPUTS = ("result", "target", "mvobj_mask")


def _prep_dense(data, roi, max_distance):
    pred, gt = preprocess_roi(data["result"], data["target"], roi)
    pred, gt = get_positive_depth(pred, gt)
    return get_absolute_depth(pred, gt, max_distance)


def _prep_sparse(data, roi, max_distance, pred_all_valid=True, use_cvmask=False):
    pred, gt = preprocess_roi(data["result"], data["target"], roi)
    mask = get_mask(pred, gt, max_distance=max_distance, pred_all_valid=pred_all_valid)
    if use_cvmask:
        # As in the JAX package, the moving-object mask is not cropped to roi.
        mask = mask | ~(data["mvobj_mask"] > 0.5)
    pred, gt = get_positive_depth(pred, gt)
    pred, gt = get_absolute_depth(pred, gt, max_distance)
    # Masked entries become 1 so ratios and logs stay finite; mask_mean
    # leaves them out of every reduction anyway.
    return torch.where(mask, 1.0, pred), torch.where(mask, 1.0, gt), mask


def _thresh_ratio(pred, gt):
    return torch.maximum(gt / pred, pred / gt)


def _dense(fn):
    def metric(data, roi=None, max_distance=None):
        return fn(*_prep_dense(data, roi, max_distance))

    return metric


def _sparse(base, pred_all_valid=True, use_cvmask=False):
    def metric(data, roi=None, max_distance=None):
        return base(*_prep_sparse(data, roi, max_distance, pred_all_valid, use_cvmask))

    return metric


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


_SPARSE_BASES = {
    "a1": _a_base(1.25), "a2": _a_base(1.25**2), "a3": _a_base(1.25**3),
    "rmse": _rmse_base, "rmse_log": _rmse_log_base, "abs_rel": _abs_rel_base,
    "sq_rel": _sq_rel_base,
}


def _a_dense(t):
    return lambda p, g: (_thresh_ratio(p, g) < t).to(p.dtype).mean()


_DENSE = {
    "a1": _a_dense(1.25), "a2": _a_dense(1.25**2), "a3": _a_dense(1.25**3),
    "rmse": lambda p, g: torch.sqrt(((p - g) ** 2).mean(dim=(1, 2, 3))).mean(),
    "rmse_log": lambda p, g: torch.sqrt(
        ((torch.log(p) - torch.log(g)) ** 2).mean(dim=(1, 2, 3))).mean(),
    "abs_rel": lambda p, g: ((p - g).abs() / g).mean(),
    "sq_rel": lambda p, g: ((p - g) ** 2 / g).mean(),
}


def sc_inv_metric(data, roi=None, max_distance=None):
    pred, gt = _prep_dense(data, roi, max_distance)
    n = gt.shape[2] * gt.shape[3]
    e = torch.log(pred) - torch.log(gt)
    e = torch.where(torch.isnan(e), 0.0, e)
    per = torch.sqrt((e**2).sum(dim=(1, 2, 3)) / n - e.sum(dim=(1, 2, 3)) ** 2 / n**2)
    return torch.where(torch.isnan(per), 0.0, per).mean()


def l1_rel_metric(data, roi=None, max_distance=None):
    pred, gt = _prep_dense(data, roi, max_distance)
    return ((pred - gt).abs() / gt).mean()


def l1_inv_metric(data, roi=None, max_distance=None):
    pred, gt = get_positive_depth(*preprocess_roi(data["result"], data["target"], roi))
    return (pred - gt).abs().mean()


def completeness_metric(data, roi=None, max_distance=None):
    return (data["result"] != 0).to(data["result"].dtype).mean()


def covered_gt_metric(data, roi=None, max_distance=None):
    # As in the JAX package: mask_mean leaves out the pixels WITH GT, so this
    # is the covered share of the pixels without GT.
    gt_invalid = data["target"] != 0
    covered = (data["result"] != 0).to(data["result"].dtype)
    return mask_mean(torch.where(gt_invalid, 0.0, covered), gt_invalid)


METRICS: Dict[str, Callable] = {}
for _name, _base in _SPARSE_BASES.items():
    METRICS[f"{_name}_metric"] = _dense(_DENSE[_name])
    METRICS[f"{_name}_sparse_metric"] = _sparse(_base)
    METRICS[f"{_name}_sparse_onlyvalid_metric"] = _sparse(_base, pred_all_valid=False)
    METRICS[f"{_name}_sparse_onlydynamic_metric"] = _sparse(_base, use_cvmask=True)
METRICS.update(sc_inv_metric=sc_inv_metric, l1_rel_metric=l1_rel_metric,
               l1_inv_metric=l1_inv_metric, completeness_metric=completeness_metric,
               covered_gt_metric=covered_gt_metric)

# Trainers key their logs and the monitor metric on ``fn.__name__``.
for _name, _fn in METRICS.items():
    _fn.__name__ = _name


def get_metric(name: str) -> Callable:
    if name not in METRICS:
        raise KeyError(f"unknown metric '{name}'; available: {sorted(METRICS)}")
    return METRICS[name]
