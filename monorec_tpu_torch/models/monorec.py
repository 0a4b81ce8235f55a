"""MonoRec composition (``monorec_tpu/models/monorec.py``).

cost volume (no grad) -> ResNet pyramid of keyframe + 0.5 -> MaskModule on
the per-frame CVs -> mask-attenuated CV -> DepthModule -> affine inverse
depth ``(1 - p) * lo + p * hi``. ``forward(batch, train=False,
generator=None, dropout_generator=None)``: the eval and the train forward of
pretrain modes 0-3. Its small random draws (the depth flip, mode 1's CV-mask
dropout in both ``pretrain_dropout_mode``s) come from ``generator``, a CPU
generator; the MaskModule's dropout (modes 0 and 2) from
``dropout_generator``, on the model's device. Under a batch sharded over
ranks every draw is made for the global batch and a rank keeps its rows
(``parallel.draw_rows``), so the generators of all ranks stay in step with
one process's. The entry points ``features``,
``cost_volume``, ``mask`` and ``depth`` serve the stage 2-4 protocol
(``train/monorec_trainer.py``); each of them and ``forward`` is a span of
``tracing``, and under ``simple_mask`` the first depth pass is also the
span ``depth_prepass`` (its ``depth`` span inside it). ``freeze_module``
("att", "depth") stops the gradient at the output of ``mask`` / ``depth``.
The mask augmentation (``augmentation: "mask"``) belongs to that trainer:
the forward applies no augmentation for it, as in the JAX package.

The variants of the JAX config:
- ``resnet_layers`` 18, 34, 50, 101 or 152; both U-Nets take the
  encoder's channels (``resnet.encoder_channels``).
- ``mask_use_cv`` / ``mask_use_feats`` off: the MaskModule sees its
  per-frame CVs / image features multiplied by 0.
- ``simple_mask``: ``SimpleMaskModule`` in place of the MaskModule. In
  modes 0 and 2 the forward runs the depth module on the raw CV, the mask
  on that finest prediction, then (mode 0) the depth module again on the
  masked CV. The JAX package builds no depth module in mode 2 and so
  cannot run a simple mask there; the port builds one (its first pass
  needs it), and mode 2's result is the mask of mode 0 with the same
  weights.
- ``no_cv``: zero cost volumes in place of the sweep (no K1 launch and no
  ``cv_uncovered``); the per-frame CVs have the source frames plus the
  stereo frame with ``use_stereo``.

With ``freeze_resnet`` (the default, as in the JAX config) the encoder's
parameters do not require gradients and it runs under ``torch.no_grad()``,
the counterpart of the JAX package's ``stop_gradient`` on the features.

Batch contract (NCHW tensors; ``data.synthetic.batch_to_torch`` builds it):
  keyframe             (B, 3, H, W)   in [-0.5, 0.5]
  keyframe_pose        (B, 4, 4)      cam-to-world
  keyframe_intrinsics  (B, 4, 4)
  frames               (B, F, 3, H, W)
  poses / intrinsics   (B, F, 4, 4)
  stereoframe(_pose/_intrinsics), mvobj_mask (B, 1, H, W), cv_depths: optional

Submodule names (``_feature_extractor``, ``att_module``, ``depth_module``)
are the reference's, so ``state_dict()`` keys match reference checkpoints
and ``monorec_tpu.convert.convert_state_dict`` reads them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from monorec_tpu_torch.models.augmentation import conditional_hflip, sample_flip_conditions
from monorec_tpu_torch.models.depth_module import DepthModule
from monorec_tpu_torch.models.mask_module import MaskModule, SimpleMaskModule
from monorec_tpu_torch.models.resnet import ResNetEncoder, encoder_channels
from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    compute_cost_volume_pair,
)
from monorec_tpu_torch.ops.cuda import build
from monorec_tpu_torch.parallel import draw_rows
from monorec_tpu_torch.precision import torch_dtype, use_exact_precision
from monorec_tpu_torch.tracing import span, traced

Tensor = torch.Tensor
Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MonoRecConfig:
    """Static model configuration: the JAX config's knobs."""

    inv_depth_min_max: Tuple[float, float] = (0.33, 0.0025)
    cv_depth_steps: int = 32
    # 0: full network; 1: depth only (random cv_mask dropout in training,
    # zero cv_mask in eval); 2: mask only; 3: depth with mvobj_mask as cv_mask.
    pretrain_mode: int = 0
    # Mode 1 in training: the CV mask is Bernoulli(pretrain_dropout) /
    # pretrain_dropout, drawn per 8x8 block (pretrain_dropout_mode 0) or per
    # sample (1).
    pretrain_dropout: float = 0.0
    pretrain_dropout_mode: int = 0
    # None | "depth" | "mask" (the last is the stage 2-4 trainer's).
    augmentation: Optional[str] = None
    freeze_resnet: bool = True
    # Submodules whose output carries no gradient: "att", "depth".
    freeze_module: Tuple[str, ...] = ()
    use_mono: bool = True
    use_stereo: bool = False
    use_ssim: int = 1
    sfcv_mult_mask: bool = True
    cv_patch_size: int = 3
    depth_large_model: bool = False
    resnet_layers: int = 18
    # SimpleMaskModule in place of the MaskModule (needs a depth pass first).
    simple_mask: bool = False
    # The MaskModule's inputs: off multiplies them by 0.
    mask_use_cv: bool = True
    mask_use_feats: bool = True
    # Zero cost volumes in place of the plane sweep.
    no_cv: bool = False
    # "float32" (exact) or "bfloat16": the dtype of the source frames that
    # the cost-volume kernels read (K1, K4; the keyframe stays float32).
    # The plain path (``cv_depths``) ignores it.
    cv_warp_dtype: str = "float32"
    # Convolution dtype of the Mask and Depth U-Nets; parameters and their
    # gradients stay float32, and so do the ResNet, losses and metrics.
    compute_dtype: str = "float32"

    def cv_config(self) -> CostVolumeConfig:
        return CostVolumeConfig(
            depth_steps=self.cv_depth_steps,
            patch_size=self.cv_patch_size,
            use_ssim=self.use_ssim,
            sfcv_mult_mask=self.sfcv_mult_mask,
            warp_dtype=self.cv_warp_dtype,
        )

    def __post_init__(self):
        for knob in ("cv_warp_dtype", "compute_dtype"):
            torch_dtype(getattr(self, knob))  # raises on an unknown name

    @property
    def has_mask_module(self) -> bool:
        return self.pretrain_mode not in (1, 3)

    @property
    def has_depth_module(self) -> bool:
        return self.pretrain_mode != 2 or self.simple_mask


def gather_cv_frames(batch: Batch, use_mono: bool, use_stereo: bool):
    """Stack the source frames / intrinsics / poses the cost volume uses."""
    frames, intr, poses = [], [], []
    if use_mono:
        frames.append(batch["frames"])
        intr.append(batch["intrinsics"])
        poses.append(batch["poses"])
    if use_stereo:
        frames.append(batch["stereoframe"][:, None])
        intr.append(batch["stereoframe_intrinsics"][:, None])
        poses.append(batch["stereoframe_pose"][:, None])
    return torch.cat(frames, 1), torch.cat(intr, 1), torch.cat(poses, 1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default conv initialisation, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)


class MonoRec(nn.Module):
    """The MonoRec network. Weights come from ``generator`` (a CPU
    ``torch.Generator``, so a seed gives the same weights on every device)
    or, later, from ``load_state_dict``; the module is then moved to
    ``device``. Constructing it turns TF32 off; ``config.compute_dtype``
    sets the U-Nets' convolution dtype."""

    def __init__(self, config: MonoRecConfig = MonoRecConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        use_exact_precision()
        self.config = cfg = config
        dtype = torch_dtype(cfg.compute_dtype)
        self._feature_extractor = ResNetEncoder(cfg.resnet_layers)
        feat = encoder_channels(cfg.resnet_layers)
        if cfg.has_mask_module:
            if cfg.simple_mask:
                self.att_module = SimpleMaskModule(cfg.cv_depth_steps, feat, dtype)
            else:
                self.att_module = MaskModule(cfg.cv_depth_steps, cfg.mask_use_cv,
                                             cfg.mask_use_feats, feat, dtype)
        if cfg.has_depth_module:
            self.depth_module = DepthModule(cfg.cv_depth_steps, cfg.depth_large_model, feat,
                                            dtype)
        if generator is not None:
            init_weights(self, generator)
        if cfg.freeze_resnet:
            self._feature_extractor.requires_grad_(False)
        if cfg.augmentation not in (None, "depth", "mask"):
            raise ValueError(f"unknown augmentation {cfg.augmentation!r}")
        if device is not None and torch.device(device).type == "cuda":
            # The forward's kernels compile side by side while the weights
            # load, not one after the other at their first launches.
            build.start("same_conv", "bias_act", *(() if cfg.no_cv else ("plane_sweep_sad",)))
        self.to(device)

    @traced("cost_volume")
    def cost_volume(self, batch: Batch, use_mono: Optional[bool] = None,
                    use_stereo: Optional[bool] = None):
        """Fused and per-frame cost volumes of the configured source frames,
        or of those ``use_mono`` / ``use_stereo`` select."""
        cfg = self.config
        use_mono = cfg.use_mono if use_mono is None else use_mono
        use_stereo = cfg.use_stereo if use_stereo is None else use_stereo
        frames, intr, poses = gather_cv_frames(batch, use_mono, use_stereo)
        return compute_cost_volume(
            batch["keyframe"], batch["keyframe_intrinsics"], batch["keyframe_pose"],
            frames, intr, poses,
            # The smaller inverse depth goes first: the sweep runs far -> near.
            cfg.inv_depth_min_max[1], cfg.inv_depth_min_max[0],
            cfg.cv_config(),
            cv_depths=batch.get("cv_depths"),
        )

    @traced("cost_volume")
    def cost_volume_pair(self, batch: Batch):
        """The mono and the stereo cost volumes of the batch's keyframes, from
        one grouped launch of K1 where the sweep path serves
        (``compute_cost_volume_pair``); returns (cv_mono, sfcv_mono,
        cv_stereo, sfcv_stereo)."""
        cfg = self.config
        return compute_cost_volume_pair(
            batch["keyframe"], batch["keyframe_intrinsics"], batch["keyframe_pose"],
            batch["frames"], batch["intrinsics"], batch["poses"],
            batch["stereoframe"], batch["stereoframe_intrinsics"], batch["stereoframe_pose"],
            cfg.inv_depth_min_max[1], cfg.inv_depth_min_max[0],
            cfg.cv_config(),
            cv_depths=batch.get("cv_depths"),
        )

    @traced("features")
    def features(self, keyframe: Tensor):
        """ResNet pyramid of keyframe + 0.5 (the reference feeds [0, 1])."""
        if self.config.freeze_resnet:
            with torch.no_grad():
                return self._feature_extractor(keyframe + 0.5)
        return self._feature_extractor(keyframe + 0.5)

    @traced("mask")
    def mask(self, single_frame_cvs: Tensor, image_features, train: bool = False,
             generator: Optional[torch.Generator] = None, keyframe: Optional[Tensor] = None,
             predicted_inverse_depth: Optional[Tensor] = None) -> Tensor:
        """The moving-object probability (B, 1, H, W): the MaskModule's, in
        training with dropout drawn from ``generator``, or under
        ``simple_mask`` the SimpleMaskModule's of the keyframe and the
        finest ``predicted_inverse_depth``."""
        if self.config.simple_mask:
            out = self.att_module(single_frame_cvs, keyframe, predicted_inverse_depth,
                                  image_features)
        else:
            out = self.att_module(single_frame_cvs, image_features, train, generator)
        return out.detach() if "att" in self.config.freeze_module else out

    @traced("depth")
    def depth(self, cost_volume: Tensor, keyframe: Tensor, image_features):
        """4-scale inverse depth, affine-mapped to [inv_depth_min_max[1], [0]]."""
        lo, hi = self.config.inv_depth_min_max[1], self.config.inv_depth_min_max[0]
        preds = self.depth_module(cost_volume, keyframe, image_features)
        preds = [(1.0 - p) * lo + p * hi for p in preds]
        if "depth" in self.config.freeze_module:
            preds = [p.detach() for p in preds]
        return preds

    def _cv_mask_dropout(self, keyframe: Tensor, generator: torch.Generator) -> Tensor:
        """Mode 1's training CV mask (``monorec_tpu/models/monorec.py:285-301``)."""
        cfg = self.config
        b, _, h, w = keyframe.shape
        keep_p = cfg.pretrain_dropout
        tail = (1, h // 8, w // 8) if cfg.pretrain_dropout_mode == 0 else (1, 1, 1)
        draw = draw_rows(lambda n: torch.bernoulli(torch.full((n,) + tail, keep_p),
                                                   generator=generator), b)
        mask = (draw / max(keep_p, 1e-8)).to(keyframe.device, keyframe.dtype)
        if cfg.pretrain_dropout_mode == 0:
            return mask.repeat_interleave(8, 2).repeat_interleave(8, 3)
        return mask.expand(b, 1, h, w)

    @traced("forward")
    def forward(self, batch: Batch, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.config
        keyframe = batch["keyframe"]
        b, _, h, w = keyframe.shape
        out: Dict[str, Any] = {}
        if train and generator is None:
            raise ValueError("the train forward draws from a generator; pass one")

        if cfg.no_cv:
            n_frames = batch["frames"].shape[1] + (1 if cfg.use_stereo else 0)
            sfcv = keyframe.new_zeros(b, n_frames, cfg.cv_depth_steps, h, w)
            cv = keyframe.new_zeros(b, cfg.cv_depth_steps, h, w)
        else:
            cv, sfcv = self.cost_volume(batch)
            # The JAX package's output schema: the pixels its TPU sweep could
            # not reach. Always 0 here: the port's sweep is a gather, with
            # full reach.
            out["cv_uncovered"] = torch.zeros(b, device=keyframe.device)

        flip = None
        if cfg.augmentation == "depth" and train:
            flip = draw_rows(lambda n: sample_flip_conditions(generator, n), b)
            keyframe, cv, sfcv = (conditional_hflip(t, flip) for t in (keyframe, cv, sfcv))
        out["cost_volume"] = cv
        out["single_frame_cvs"] = sfcv

        feats = self.features(keyframe)
        out["image_features"] = feats

        if cfg.pretrain_mode in (0, 2) and cfg.simple_mask:
            # The mask takes this pass's finest prediction detached, so the
            # pass records no graph.
            with torch.no_grad(), span("depth_prepass"):
                pre_preds = self.depth(cv, keyframe, feats)
            cv_mask = self.mask(sfcv, feats, train, dropout_generator, keyframe, pre_preds[0])
        elif cfg.pretrain_mode in (0, 2):
            cv_mask = self.mask(sfcv, feats, train, dropout_generator)
        elif cfg.pretrain_mode == 1:
            cv_mask = (self._cv_mask_dropout(keyframe, generator) if train
                       else keyframe.new_zeros(b, 1, h, w))
        else:
            cv_mask = batch["mvobj_mask"].detach()
        out["cv_mask"] = cv_mask

        if cfg.pretrain_mode != 2:
            masked_cv = (1.0 - cv_mask) * cv
            out["cost_volume"] = masked_cv
            out["predicted_inverse_depths"] = self.depth(masked_cv, keyframe, feats)

        if flip is not None:
            # Revert: orient every output like the un-augmented inputs.
            for key in ("cost_volume", "single_frame_cvs", "cv_mask"):
                out[key] = conditional_hflip(out[key], flip)
            if cfg.pretrain_mode != 2:
                out["predicted_inverse_depths"] = [
                    conditional_hflip(p, flip) for p in out["predicted_inverse_depths"]]

        if cfg.pretrain_mode == 2:
            out["result"] = out["cv_mask"]
        else:
            out["result"] = out["predicted_inverse_depths"][0]
            out["mask"] = out["cv_mask"]
        return out
