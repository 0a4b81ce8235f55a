"""Stage losses of the MonoRec curriculum (``monorec_tpu/losses/
monorec_losses.py``): the stage-1 ``depth_loss`` and the stage-2
``mask_loss``. The refinement losses of stages 3-4 are not ported yet
(ROADMAP item 16).

A loss is ``loss(data, alpha=None, roi=None, options=()) -> dict`` with a
``"loss"`` entry, where ``data`` merges the batch, the model outputs and
``"target"`` (inverse-depth GT (B, 1, H, W), 0 = invalid).
"""

from __future__ import annotations

from typing import Dict

import torch

from monorec_tpu_torch.losses.common import (
    edge_aware_smoothness_loss,
    identity_reprojection_errors,
    reprojection_loss,
    sparse_depth_loss,
    tile_batch_for_scales,
    upsample_nearest_to,
)
from monorec_tpu_torch.utils import mask_mean

Tensor = torch.Tensor


def depth_loss(data: Dict, alpha=None, roi=None, options=()) -> Dict[str, Tensor]:
    """Stage-1 depth bootstrap loss (reference ``monorec_loss.py:9-47``).

    All scales go through ONE batched reprojection pass: the upsampled
    predictions are stacked along the batch axis (scale-major), so the loss
    warp and the photometric error each run once per step, and the
    scale-invariant automasking errors are computed once. The total is
    ``2 alpha 4 sum(sdl_i) + 2 (1 - alpha) sum(md2l_i)``; ``-o stereo``
    (``"stereo"`` in ``options``) adds the stereo frame to the
    reprojection.
    """
    use_stereo = "stereo" in options
    alpha = 0.5 if alpha is None else alpha
    gt = torch.clamp(data["target"], 0.0, 100.0)
    b, _, h, w = gt.shape
    preds = [upsample_nearest_to(torch.clamp_min(p, 0.0), h, w)
             for p in data["predicted_inverse_depths"]]
    s = len(preds)

    loss_dict: Dict[str, Tensor] = {}
    sdl_sum = 0.0
    for i, pred in enumerate(preds):
        sdl = sparse_depth_loss(pred, gt)
        sdl_sum = sdl_sum + sdl
        loss_dict[f"sdl_{i}"] = sdl

    am = identity_reprojection_errors(data, use_mono=True, use_stereo=use_stereo)
    r_map, cov_sum = reprojection_loss(
        torch.cat(preds, 0), tile_batch_for_scales(data, s), automasking=True, use_mono=True,
        use_stereo=use_stereo, reduce=False, combine_frames="min",
        automask_errors=am.repeat(s, 1, 1, 1), with_coverage=True,
    )
    invalid = torch.isinf(r_map).reshape(s, b, h, w)
    r_map = torch.where(invalid.reshape(r_map.shape), 0.0, r_map).reshape(s, b, h, w)

    md2l_sum = 0.0
    for i, pred in enumerate(preds):
        r = mask_mean(r_map[i], invalid[i])
        r = torch.where(torch.isnan(r), 0.0, r)
        sm = edge_aware_smoothness_loss(pred, data["keyframe"])
        sm = torch.where(torch.isnan(sm), 0.0, sm)
        md2l = r + sm * 1e-3 / (2**i)
        md2l_sum = md2l_sum + md2l
        loss_dict[f"md2l_{i}"] = md2l

    loss_dict["loss"] = 2 * alpha * 4 * sdl_sum + 2 * (1 - alpha) * md2l_sum
    # Loss-warp observability: in-image pixels the warp could not reach.
    # Always 0 for a gather kernel; kept for the JAX package's log schema.
    loss_dict["warp_uncovered"] = cov_sum
    return loss_dict


_MVG_RATIO = 0.008109558  # the reference's share of moving pixels (monorec_loss.py:57)


def _mask_stats(cv_mask: Tensor, gt_mask: Tensor) -> Dict[str, Tensor]:
    """Accuracy, precision, recall and IoU of ``cv_mask > 0.5`` against
    ``gt_mask > 0.5``, averaged over the batch. They stay finite: precision
    (recall) is 1 - clip(intersection, 0, 1) where nothing is predicted
    (nothing is moving), and IoU is 1 on an empty union
    (``PARITY.md:319-329``)."""
    gt_pred, cv_pred = gt_mask > 0.5, cv_mask > 0.5
    dims = (1, 2, 3)
    inter = (cv_pred & gt_pred).sum(dims).float()
    union = (cv_pred | gt_pred).sum(dims).float()
    gt_sum, cv_sum = gt_pred.sum(dims).float(), cv_pred.sum(dims).float()
    empty = 1.0 - inter.clamp(0, 1)
    prec = torch.where(cv_sum == 0, empty, inter / cv_sum.clamp_min(1))
    rec = torch.where(gt_sum == 0, empty, inter / gt_sum.clamp_min(1))
    iou = torch.where(union == 0, 1.0, inter / union.clamp_min(1))
    return {"acc": (cv_pred == gt_pred).float().mean(), "prec": prec.mean(),
            "rec": rec.mean(), "iou": iou.mean()}


def mask_loss(data: Dict, alpha=None, roi=None, options=()) -> Dict[str, Tensor]:
    """Stage-2 mask bootstrap (reference ``monorec_loss.py:50-96``): the
    class-balanced binary cross-entropy of ``cv_mask`` against
    ``mvobj_mask``, each class weighted by the inverse of its share
    ``_MVG_RATIO``, times ``multiplicative_weight_mask`` where the data
    holds one; each log term clamped at -100 as torch's BCE does. Adds the
    ``_mask_stats``."""
    gt_mask, cv_mask = data["mvobj_mask"], data["cv_mask"]
    weight = torch.where(gt_mask > 0, 1.0 / _MVG_RATIO, 1.0 / (1.0 - _MVG_RATIO))
    if "multiplicative_weight_mask" in data:
        weight = weight * data["multiplicative_weight_mask"]
    p = torch.clamp(cv_mask, 1e-12, 1.0 - 1e-12)
    g = gt_mask.float()
    bce = -(g * torch.clamp_min(torch.log(p), -100.0)
            + (1 - g) * torch.clamp_min(torch.log(1 - p), -100.0))
    return {"loss": (weight * bce).mean(), **_mask_stats(cv_mask, gt_mask)}


LOSSES = {"depth_loss": depth_loss, "mask_loss": mask_loss}
