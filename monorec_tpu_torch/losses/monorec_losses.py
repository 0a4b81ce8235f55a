"""Stage losses of the MonoRec curriculum (``monorec_tpu/losses/
monorec_losses.py``): the stage-1 ``depth_loss``, the stage-2 ``mask_loss``,
the stage-3 ``mask_refinement_loss``, the stage-4 ``depth_refinement_loss``
and the unused ``depth_aux_mask_loss``. Each keeps the JAX function's
quirks, which the curriculum's logs and totals depend on (ROADMAP Queue 3).

A loss is ``loss(data, alpha=None, roi=None, options=()) -> dict`` with a
``"loss"`` entry, where ``data`` merges the batch, the model outputs and
``"target"`` (inverse-depth GT (B, 1, H, W), 0 = invalid).

Every reduction that couples samples (``mask_mean`` over the batch, the
batch means, the counts) goes through ``parallel``: under a batch sharded
over ranks it is the global batch's, so the loss dict equals the one of one
process over the whole batch. Per-sample reductions stay local.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from monorec_tpu_torch.losses.common import (
    edge_aware_smoothness_loss,
    identity_reprojection_errors,
    reprojection_loss,
    sparse_depth_loss,
    tile_batch_for_scales,
    upsample_nearest_to,
)
from monorec_tpu_torch.parallel import batch_mean, global_sum
from monorec_tpu_torch.utils import mask_mean

Tensor = torch.Tensor


def _warp_uncovered(like: Tensor) -> Tensor:
    """The loss dicts' ``warp_uncovered``, which the JAX package's log schema
    holds: the in-image pixels its TPU loss warp could not reach. Always 0
    here: the port's loss warp is a gather, with full reach."""
    return like.new_zeros(())


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
    r_map = reprojection_loss(
        torch.cat(preds, 0), tile_batch_for_scales(data, s), automasking=True, use_mono=True,
        use_stereo=use_stereo, reduce=False, combine_frames="min",
        automask_errors=am.repeat(s, 1, 1, 1),
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
    loss_dict["warp_uncovered"] = _warp_uncovered(gt)
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
    return {"acc": batch_mean((cv_pred == gt_pred).float()), "prec": batch_mean(prec),
            "rec": batch_mean(rec), "iou": batch_mean(iou)}


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
    return {"loss": batch_mean(weight * bce), **_mask_stats(cv_mask, gt_mask)}


def _dist_diff(mono_pred: Tensor, gt_mask: Tensor, cv_mask: Tensor, threshold, scale: int):
    """The dist_diff term of one scale (reference ``monorec_loss.py:135-160``):
    pixels that move (``gt_mask``) and that the mono prediction puts far
    (below the ``threshold`` inverse depth), dilated by a majority vote over a
    (b + 1)^2 window, b = 16 / 2^scale, and cropped; returns the mean of
    -log(cv_mask) there, times 1/8, and the far pixels ``mono_thresh``."""
    b = 16 // 2**scale
    mono_thresh = mono_pred.detach() < threshold
    dd = (mono_thresh & gt_mask).to(torch.float32)
    # Integer box counts (exact in float32), so the >= test cannot flip at
    # equality as an average could.
    padded = F.pad(dd, (b // 2, b - b // 2, b // 2, b - b // 2))
    box = F.conv2d(padded, torch.ones(1, 1, b + 1, b + 1, device=dd.device))
    dd_c = (box >= (b + 1) ** 2 / 4)[:, :, 4 * b : -b, b:-b]
    logp = -torch.log(torch.clamp(cv_mask[:, :, 4 * b : -b, b:-b], 1e-12, 1.0))
    total, count = global_sum(torch.stack([torch.where(dd_c, logp, 0.0).sum(),
                                           dd_c.float().sum()])).unbind()
    dist = total / torch.clamp_min(count, 1.0)
    return dist * 2.0**-3, mono_thresh


def mask_refinement_loss(data: Dict, alpha=None, roi=None, options=()) -> Dict[str, Tensor]:
    """Stage-3 mask refinement (reference ``monorec_loss.py:99-219``).

    The mono prediction supervises the static pixels and the stereo one the
    moving pixels, each weighted by ``cv_mask``: sparse depth, reprojection
    (mono frames; the stereo frame with a 3-pixel border) and smoothness.
    All scales of each branch go through ONE reprojection pass, stacked
    scale-major. The mono predictions are not clamped at 0.

    Options: ``dist_diff_loss`` adds ``_dist_diff`` per scale to the mask
    term and weights the far, static pixels by 1e-3 in the mask loss (the
    last scale's weight is the one kept); ``mask_loss`` adds the BCE of
    ``mask_loss`` and REPLACES the mask term with it, so with both options
    the dist_diff terms are logged but leave the total. ``mask_loss`` is
    logged at four times the value the total adds. As in the JAX package.
    """
    alpha = 0.5 if alpha is None else alpha
    gt = torch.clamp(data["target"], 0.0, 100.0)
    b, _, h, w = gt.shape
    cv_mask = data["cv_mask"]
    gt_mask = data["mvobj_mask"] > 0.5
    threshold = (data["inv_depth_min"] - data["inv_depth_max"]) / 32 * 2 + data["inv_depth_max"]

    loss_dict: Dict[str, Tensor] = dict(_mask_stats(cv_mask, data["mvobj_mask"]))
    sdl_sum = md2l_sum = mask_loss_value = 0.0

    mono_preds = [upsample_nearest_to(p, h, w) for p in data["mono_pred"]]
    stereo_preds = [upsample_nearest_to(p, h, w) for p in data["stereo_pred"]]
    s = len(mono_preds)
    tiled = tile_batch_for_scales(data, s)
    mono_all = reprojection_loss(
        torch.cat(mono_preds, 0), tiled, use_mono=True, use_stereo=False, automasking=False,
        reduce=False, combine_frames="min")
    stereo_all = reprojection_loss(
        torch.cat(stereo_preds, 0), tiled, use_mono=False, use_stereo=True, automasking=False,
        reduce=False, combine_frames="min", border=3)
    mono_all, stereo_all = mono_all.reshape(s, b, 1, h, w), stereo_all.reshape(s, b, 1, h, w)

    weight_data = data
    for scale, (mono_pred, stereo_pred) in enumerate(zip(mono_preds, stereo_preds)):
        mono_sdl, mono_inv = sparse_depth_loss(mono_pred, gt, reduce=False)
        stereo_sdl, stereo_inv = sparse_depth_loss(stereo_pred, gt, reduce=False)
        sdl = (mask_mean(mono_sdl * (1 - cv_mask), mono_inv)
               + mask_mean(stereo_sdl * cv_mask, stereo_inv))
        sdl_sum = sdl_sum + sdl
        loss_dict[f"sdl_{scale}"] = sdl

        if "dist_diff_loss" in options:
            dist_diff, mono_thresh = _dist_diff(mono_pred, gt_mask, cv_mask, threshold, scale)
            loss_dict[f"dist_diff_{scale}"] = dist_diff
            mask_loss_value = mask_loss_value + dist_diff
            weight_data = {**data, "multiplicative_weight_mask": torch.where(
                mono_thresh & ~gt_mask, 1e-3, 1.0)}

        mono_sm = edge_aware_smoothness_loss(mono_pred, data["keyframe"], reduce=False)
        stereo_sm = edge_aware_smoothness_loss(stereo_pred, data["keyframe"], reduce=False)
        smoothness = batch_mean(mono_sm * (1 - cv_mask) + stereo_sm * cv_mask)

        mono_inf, stereo_inf = torch.isinf(mono_all[scale]), torch.isinf(stereo_all[scale])
        mono_repr = torch.where(mono_inf, 0.0, mono_all[scale])
        stereo_repr = torch.where(stereo_inf, 0.0, stereo_all[scale])
        loss_dict[f"static_md2l_{scale}"] = mask_mean(mono_repr, mono_inf)
        loss_dict[f"dynamic_md2l_{scale}"] = mask_mean(stereo_repr, stereo_inf)
        mono_repr = mono_repr * torch.maximum(1 - cv_mask, stereo_inf.float())
        stereo_repr = stereo_repr * torch.maximum(cv_mask, mono_inf.float())
        md2l = (mask_mean(mono_repr + stereo_repr, mono_inf & stereo_inf)
                + smoothness * 1e-3 / (2**scale))
        loss_dict[f"md2l_{scale}"] = md2l
        md2l_sum = md2l_sum + md2l

    if "mask_loss" in options:
        ml = mask_loss(weight_data)
        mask_loss_value = ml.pop("loss")
        loss_dict.update(ml)
        loss_dict["mask_loss"] = mask_loss_value * 4

    loss_dict["loss"] = 2 * alpha * 4 * sdl_sum + 2 * (1 - alpha) * md2l_sum + mask_loss_value
    loss_dict["warp_uncovered"] = _warp_uncovered(gt)
    return loss_dict


def depth_refinement_loss(data: Dict, alpha=None, roi=None, options=()) -> Dict[str, Tensor]:
    """Stage-4 depth refinement (reference ``monorec_loss.py:283-378``).

    Pixels with ``cv_mask > 0.5`` are moving; ``ratio`` is their share of
    B * 1 * H * W. Static pixels are supervised by the sparse GT and the
    mono reprojection (automasked; ``stereo`` adds the stereo frame), moving
    ones by the stereo prediction as pseudo-GT (unless ``no_mono_stereodl``)
    and, with ``stereo_repr``, by the stereo frame's reprojection with a
    3-pixel border. Both sparse-depth terms are DETACHED, as in the JAX
    package, so only the photometric and smoothness terms give gradients.
    ``cv_mask`` enters through its threshold only, so it gets none.

    When no pixel, or every pixel, is moving, a masked mean over nothing
    gives NaN in the same keys as the JAX function (the total among them);
    the gradients stay finite, since ``torch.where`` selects the NaN away.
    """
    alpha = 0.5 if alpha is None else alpha
    use_stereo = "stereo" in options
    use_stereo_reprl = "stereo_repr" in options
    use_mono_stereodl = "no_mono_stereodl" not in options

    gt = torch.clamp(data["target"], 0.0, 100.0)
    b, _, h, w = gt.shape
    cv_disc = (data["cv_mask"] > 0.5).to(torch.float32)
    ratio = batch_mean(cv_disc)

    mono_preds = [upsample_nearest_to(p, h, w) for p in data["mono_pred"]]
    s = len(mono_preds)
    stereo_preds = data["stereo_pred"] if use_mono_stereodl else [None] * s
    stacked = torch.cat(mono_preds, 0)
    tiled = tile_batch_for_scales(data, s)
    am = identity_reprojection_errors(data, use_mono=True, use_stereo=use_stereo)
    mono_all = reprojection_loss(
        stacked, tiled, use_mono=True, use_stereo=use_stereo, automasking=True, reduce=False,
        combine_frames="min", automask_errors=am.repeat(s, 1, 1, 1))
    mono_all = mono_all.reshape(s, b, 1, h, w)
    if use_stereo_reprl:
        st_all = reprojection_loss(
            stacked, tiled, use_mono=False, use_stereo=True, automasking=False, reduce=False,
            combine_frames="min", border=3)
        st_all = st_all.reshape(s, b, 1, h, w)

    loss_dict: Dict[str, Tensor] = {}
    sdl_sum = md2l_sum = 0.0
    for scale, (mono_pred, stereo_pred) in enumerate(zip(mono_preds, stereo_preds)):
        mono_sdl_map, mono_inv = sparse_depth_loss(mono_pred, gt * (1 - cv_disc), reduce=False)
        mono_sdl = mask_mean(mono_sdl_map.detach(), mono_inv)
        if use_mono_stereodl:
            stereo_pred = upsample_nearest_to(stereo_pred, h, w).detach()
            st_map, st_inv = sparse_depth_loss(mono_pred, stereo_pred * cv_disc, reduce=False)
            stereo_sdl = mask_mean(st_map, st_inv).detach()
        else:
            stereo_sdl = 0.0
        sdl = mono_sdl * (1 - ratio) + stereo_sdl * ratio * 4
        sdl_sum = sdl_sum + sdl
        loss_dict[f"sdl_{scale}"] = sdl

        # The reference adds the un-reduced map and the trainer means the
        # sum; the mean here gives the same value as a scalar.
        smoothness = batch_mean(
            edge_aware_smoothness_loss(mono_pred, data["keyframe"], reduce=False))

        mono_inf = torch.isinf(mono_all[scale]) | (cv_disc > 0.5)
        mono_repr = mask_mean(torch.where(mono_inf, 0.0, mono_all[scale]), mono_inf)
        if use_stereo_reprl:
            st_inf = torch.isinf(st_all[scale]) | (cv_disc <= 0.5)
            st_repr = mask_mean(torch.where(st_inf, 0.0, st_all[scale]), st_inf)
        else:
            st_repr = torch.zeros_like(mono_repr)
        loss_dict[f"static_md2l_{scale}"] = mono_repr.detach()
        loss_dict[f"dynamic_md2l_{scale}"] = st_repr

        md2l = mono_repr * (1 - ratio) + st_repr * ratio + smoothness * 1e-3 / (2**scale)
        loss_dict[f"md2l_{scale}"] = md2l
        md2l_sum = md2l_sum + md2l

    loss_dict["loss"] = 2 * alpha * 4 * sdl_sum + 2 * (1 - alpha) * md2l_sum
    loss_dict["warp_uncovered"] = _warp_uncovered(gt)
    return loss_dict


def depth_aux_mask_loss(data: Dict, alpha=None, roi=None, options=()) -> Dict[str, Tensor]:
    """Auxiliary mask-gated depth loss (reference ``monorec_loss.py:222-280``;
    no shipped config uses it): the stage-1 terms of the mono prediction on
    the pixels with ``cv_mask <= 0.5`` only, one reprojection pass per
    scale."""
    alpha = 0.5 if alpha is None else alpha
    gt = torch.clamp(data["target"], 0.0, 100.0)
    h, w = gt.shape[-2:]
    moving = data["cv_mask"].detach() > 0.5

    loss_dict: Dict[str, Tensor] = {}
    sdl_sum = md2l_sum = 0.0
    for scale, mono_pred in enumerate(data["mono_pred"]):
        mono_pred = upsample_nearest_to(mono_pred, h, w)
        sdl_map, sdl_inv = sparse_depth_loss(mono_pred, gt, reduce=False)
        sdl = mask_mean(sdl_map, sdl_inv | moving)
        sdl_sum = sdl_sum + sdl
        loss_dict[f"sdl_{scale}"] = sdl

        smoothness = mask_mean(
            edge_aware_smoothness_loss(mono_pred, data["keyframe"], reduce=False), moving)
        mono_repr = reprojection_loss(
            mono_pred, data, use_mono=True, use_stereo=False, automasking=False, reduce=False,
            combine_frames="min")[:, None]
        mono_inf = torch.isinf(mono_repr)
        mono_repr = torch.where(mono_inf, 0.0, mono_repr)
        loss_dict[f"static_md2l_{scale}"] = mask_mean(mono_repr, mono_inf)
        md2l = mask_mean(mono_repr, mono_inf | moving) + smoothness * 1e-3 / (2**scale)
        loss_dict[f"md2l_{scale}"] = md2l
        md2l_sum = md2l_sum + md2l

    loss_dict["loss"] = 2 * alpha * 4 * sdl_sum + 2 * (1 - alpha) * md2l_sum
    loss_dict["warp_uncovered"] = _warp_uncovered(gt)
    return loss_dict


LOSSES = {
    "depth_loss": depth_loss,
    "mask_loss": mask_loss,
    "mask_refinement_loss": mask_refinement_loss,
    "depth_refinement_loss": depth_refinement_loss,
    "depth_aux_mask_loss": depth_aux_mask_loss,
}
