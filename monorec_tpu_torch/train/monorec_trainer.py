"""Stage 2-4 trainer (``monorec_tpu/train/monorec_trainer.py``): the
multi-pass MonoRec protocol of the reference's ``MonoRecTrainer._feed``.

One ``_feed``, in the JAX package's order:

  0) with ``color_aug_on_device``, in training, the colour jitter of every
     image key (``Trainer._jitter``) before anything else reads the batch;
  A) augmentation: with ``augmentation: "depth"`` a per-sample flip of the
     keyframe and the moving-object mask; with ``"mask"`` one flip and
     resized crop per sample (``models/augmentation.py``, through K2) of the
     keyframe, the frames, the stereo frame and the mask, whose crop
     ``> 0.5`` becomes the target;
  B) the ResNet features of the augmented keyframe;
  C) the cost volumes, computed from the UN-augmented batch without a
     gradient and augmented afterwards: the stereo one
     (``compute_stereo_pred``), then the mono one; with ``joint_cv`` both
     from one grouped launch of K1 (``MonoRec.cost_volume_pair``);
  D) the MaskModule on the mono per-frame CVs (``compute_mask``; its
     dropout from the trainer's device generator), optionally attenuating
     the mono CV (``mult_mask_on_cv``);
  E) the depth decodes: stereo (without a gradient unless
     ``concat_mono_stereo``) and mono (``compute_mono_pred``); with
     ``joint_depth_decode`` and both, one DepthModule pass over the 2B
     samples ``[mono, stereo]``, split at B, the stereo half detached unless
     ``concat_mono_stereo`` (the backward then runs over all 2B samples, the
     stereo half's cotangents zero, as the JAX package's does);
  F) the revert of the flip on the predictions and masks (the mask
     augmentation has none), the optional batch doubling of
     ``concat_mono_stereo``, and the stage loss on the merged data.

``joint_cv`` and ``joint_depth_decode`` are off by default and in every
shipped config, as in the JAX trainer; each result equals the separate
passes'.

Two JAX quirks the port keeps. A ``simple_mask`` model is refused: the JAX
trainer calls ``MonoRec.mask`` with no keyframe and no depth prediction
(``monorec_tpu/train/monorec_trainer.py:151``), so it cannot run one.
``no_cv`` is ignored: the cost volumes are computed all the same, as the
JAX ``_feed`` does. ``mask_use_cv`` / ``mask_use_feats`` act through the
MaskModule.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from monorec_tpu_torch import tracing
from monorec_tpu_torch.models.augmentation import (
    apply_mask_aug,
    apply_mask_aug_frames,
    conditional_hflip,
    sample_flip_conditions,
    sample_mask_aug_params,
)
from monorec_tpu_torch.parallel import draw_rows
from monorec_tpu_torch.train.trainer import Trainer

class MonoRecTrainer(Trainer):
    """The stage 2-4 trainer; flags from the config's ``trainer`` block."""

    def __init__(self, model, *args, **kwargs):
        if model.config.simple_mask:
            raise NotImplementedError(
                "the stage 2-4 trainer cannot run a simple_mask model: the JAX trainer calls "
                "MonoRec.mask with no keyframe and no depth prediction "
                "(monorec_tpu/train/monorec_trainer.py:151)")
        super().__init__(model, *args, **kwargs)
        tcfg = self.config.get("trainer", {})
        self.compute_mono_pred = tcfg.get("compute_mono_pred", True)
        self.compute_stereo_pred = tcfg.get("compute_stereo_pred", True)
        self.compute_mask = tcfg.get("compute_mask", True)
        self.mult_mask_on_cv = tcfg.get("mult_mask_on_cv", False)
        self.concat_mono_stereo = tcfg.get("concat_mono_stereo", False)
        self.joint_depth_decode = tcfg.get("joint_depth_decode", False)
        self.joint_cv = tcfg.get("joint_cv", False)

    @tracing.traced("feed")
    def _feed(self, batch: Dict, train: bool, alpha: float) -> Tuple[Dict, Dict]:
        batch = self._jitter(batch, train)
        model = self.model
        cfg = model.config
        b = batch["keyframe"].shape[0]
        lo, hi = cfg.inv_depth_min_max[1], cfg.inv_depth_min_max[0]

        # --- A) augmentation parameters and the augmented input view -------
        aug = cfg.augmentation if train else None
        data = dict(batch)
        flip = None
        if aug == "depth":
            flip = draw_rows(lambda n: sample_flip_conditions(self.generator, n), b)

            def aug_one(x):
                return conditional_hflip(x, flip)

            data["keyframe"] = aug_one(batch["keyframe"])
            if "mvobj_mask" in batch:
                data["mvobj_mask"] = aug_one(batch["mvobj_mask"])
        elif aug == "mask":
            h, w = batch["keyframe"].shape[-2:]
            params = draw_rows(lambda n: sample_mask_aug_params(self.generator, n, h, w), b)
            params = params.to(batch["keyframe"].device)

            def aug_one(x):
                if x.dim() == 5:  # (B, F, C, H, W): frame stacks, per-frame CVs
                    return apply_mask_aug_frames(x, params)
                return apply_mask_aug(x, params)

            data["keyframe"] = aug_one(batch["keyframe"])
            data["frames"] = aug_one(batch["frames"])
            if "stereoframe" in batch:
                data["stereoframe"] = aug_one(batch["stereoframe"])
            target = (aug_one(batch["mvobj_mask"]) > 0.5).float()
            data["mvobj_mask"] = target
            data["target"] = target
        else:
            def aug_one(x):
                return x

        data["inv_depth_min"] = hi
        data["inv_depth_max"] = lo

        # --- B) features of the augmented keyframe ---------------------------
        feats = model.features(data["keyframe"])

        # --- C) cost volumes of the un-augmented batch, then augmented ------
        cv_s = None
        with torch.no_grad():
            if self.compute_stereo_pred and self.joint_cv:
                cv_m, sfcv_m, cv_s, sfcv_s = model.cost_volume_pair(batch)
                cv_s, sfcv_s = aug_one(cv_s), aug_one(sfcv_s)
            else:
                if self.compute_stereo_pred:
                    cv_s, sfcv_s = model.cost_volume(batch, use_mono=False, use_stereo=True)
                    cv_s, sfcv_s = aug_one(cv_s), aug_one(sfcv_s)
                cv_m, sfcv_m = model.cost_volume(batch, use_mono=True, use_stereo=False)
            cv_m, sfcv_m = aug_one(cv_m), aug_one(sfcv_m)
        # The JAX package's schema, as ``MonoRec.forward`` gives it: 0, the
        # port's sweep is a gather, with full reach.
        data["cv_uncovered"] = torch.zeros(b, device=cv_m.device)

        # --- D) the mask ---------------------------------------------------
        if self.compute_mask:
            cv_mask = model.mask(sfcv_m, feats, train=train, generator=self.device_generator)
            if self.mult_mask_on_cv:
                cv_m = cv_m * (1.0 - cv_mask)
        else:
            cv_mask = torch.zeros_like(cv_m[:, :1])

        # --- E) depth decodes (one DepthModule, two inputs) ------------------
        stereo_pred = None
        if self.compute_stereo_pred and self.compute_mono_pred and self.joint_depth_decode:
            preds = model.depth(torch.cat([cv_m, cv_s]), torch.cat([data["keyframe"]] * 2),
                                [torch.cat([f, f]) for f in feats])
            mono_pred = [p[:b] for p in preds]
            stereo_pred = [p[b:] if self.concat_mono_stereo else p[b:].detach() for p in preds]
        else:
            if self.compute_stereo_pred:
                # Without concat_mono_stereo the stereo prediction is a target
                # only: decoding it without a gradient equals detaching it.
                grad = contextlib.nullcontext() if self.concat_mono_stereo else torch.no_grad()
                with grad:
                    stereo_pred = model.depth(cv_s, data["keyframe"], feats)
            if self.compute_mono_pred:
                mono_pred = model.depth(cv_m, data["keyframe"], feats)
            else:
                mono_pred = [torch.zeros_like(cv_m[:, :1])]

        data["cost_volume"] = cv_m
        data["single_frame_cvs"] = sfcv_m
        data["cv_mask"] = cv_mask
        data["mono_pred"] = mono_pred
        data["stereo_pred"] = stereo_pred
        data["predicted_inverse_depths"] = mono_pred
        data["result"] = mono_pred[0]
        data["mask"] = cv_mask

        # --- F) revert the flip (the mask augmentation has no revert) -------
        if flip is not None:
            def rev(x):
                return conditional_hflip(x, flip)

            data["keyframe"] = batch["keyframe"]
            if "mvobj_mask" in batch:
                data["mvobj_mask"] = batch["mvobj_mask"]
            data["cv_mask"] = rev(data["cv_mask"])
            data["mask"] = data["cv_mask"]
            data["mono_pred"] = [rev(p) for p in data["mono_pred"]]
            if data["stereo_pred"] is not None:
                data["stereo_pred"] = [rev(p) for p in data["stereo_pred"]]
            data["predicted_inverse_depths"] = data["mono_pred"]
            data["result"] = data["mono_pred"][0]

        if self.concat_mono_stereo:
            for key in ("keyframe", "keyframe_pose", "keyframe_intrinsics", "stereoframe",
                        "stereoframe_pose", "stereoframe_intrinsics", "frames", "poses",
                        "intrinsics", "mask", "cv_mask", "target"):
                if data.get(key) is not None:
                    data[key] = torch.cat([data[key], data[key]], 0)
            # The un-reverted predictions, as the JAX package concatenates them.
            data["predicted_inverse_depths"] = [
                torch.cat([m, s], 0) for m, s in zip(mono_pred, stereo_pred)]
            data["result"] = data["predicted_inverse_depths"][0]

        with tracing.span("loss"):
            loss_dict = self.loss_fn(data, alpha, self.roi, self.options)
        return loss_dict, data
