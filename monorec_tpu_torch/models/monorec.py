"""MonoRec composition (``monorec_tpu/models/monorec.py``): the eval forward.

cost volume (no grad) -> ResNet pyramid of keyframe + 0.5 -> MaskModule on
the per-frame CVs -> mask-attenuated CV -> DepthModule -> affine inverse
depth ``(1 - p) * lo + p * hi``. Pretrain modes 0-3 are supported in their
eval form; the train-mode branches (mask dropout, mode-1 random CV-mask
dropout) and augmentation are not ported yet, so ``forward`` computes the
eval forward in either module mode. The JAX config's ``no_cv``,
``mask_use_cv``, ``mask_use_feats`` and ``simple_mask`` are not ported yet
either.

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

from monorec_tpu_torch.models.depth_module import DepthModule
from monorec_tpu_torch.models.mask_module import MaskModule
from monorec_tpu_torch.models.resnet import ResNetEncoder
from monorec_tpu_torch.ops.cost_volume import CostVolumeConfig, compute_cost_volume
from monorec_tpu_torch.precision import use_exact_precision

Tensor = torch.Tensor
Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MonoRecConfig:
    """Static model configuration (the eval subset of the JAX config)."""

    inv_depth_min_max: Tuple[float, float] = (0.33, 0.0025)
    cv_depth_steps: int = 32
    # 0: full network; 1: depth only (zero cv_mask in eval);
    # 2: mask only; 3: depth with mvobj_mask as cv_mask.
    pretrain_mode: int = 0
    use_mono: bool = True
    use_stereo: bool = False
    use_ssim: int = 1
    sfcv_mult_mask: bool = True
    cv_patch_size: int = 3
    depth_large_model: bool = False
    resnet_layers: int = 18
    # Compute the cost volume on its plain path (projection + grid_sample)
    # instead of the fused sweep: the A/B baseline for the CUDA kernel.
    plain_cost_volume: bool = False

    def cv_config(self) -> CostVolumeConfig:
        return CostVolumeConfig(
            depth_steps=self.cv_depth_steps,
            patch_size=self.cv_patch_size,
            use_ssim=self.use_ssim,
            sfcv_mult_mask=self.sfcv_mult_mask,
        )

    @property
    def has_mask_module(self) -> bool:
        return self.pretrain_mode not in (1, 3)

    @property
    def has_depth_module(self) -> bool:
        return self.pretrain_mode != 2


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
    ``device``. Constructing it pins the exact float32 policy."""

    def __init__(self, config: MonoRecConfig = MonoRecConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        use_exact_precision()
        self.config = cfg = config
        self._feature_extractor = ResNetEncoder(cfg.resnet_layers)
        if cfg.has_mask_module:
            self.att_module = MaskModule(cfg.cv_depth_steps)
        if cfg.has_depth_module:
            self.depth_module = DepthModule(cfg.cv_depth_steps, cfg.depth_large_model)
        if generator is not None:
            init_weights(self, generator)
        self.to(device)

    def cost_volume(self, batch: Batch, return_coverage: bool = False):
        cfg = self.config
        frames, intr, poses = gather_cv_frames(batch, cfg.use_mono, cfg.use_stereo)
        return compute_cost_volume(
            batch["keyframe"], batch["keyframe_intrinsics"], batch["keyframe_pose"],
            frames, intr, poses,
            # The smaller inverse depth goes first: the sweep runs far -> near.
            cfg.inv_depth_min_max[1], cfg.inv_depth_min_max[0],
            cfg.cv_config(),
            cv_depths=batch.get("cv_depths"),
            plain=cfg.plain_cost_volume,
            return_coverage=return_coverage,
        )

    def depth(self, cost_volume: Tensor, keyframe: Tensor, image_features):
        """4-scale inverse depth, affine-mapped to [inv_depth_min_max[1], [0]]."""
        lo, hi = self.config.inv_depth_min_max[1], self.config.inv_depth_min_max[0]
        preds = self.depth_module(cost_volume, keyframe, image_features)
        return [(1.0 - p) * lo + p * hi for p in preds]

    def forward(self, batch: Batch) -> Dict[str, Any]:
        cfg = self.config
        keyframe = batch["keyframe"]
        b, _, h, w = keyframe.shape
        out: Dict[str, Any] = {}

        cv, sfcv, out["cv_uncovered"] = self.cost_volume(batch, return_coverage=True)
        out["cost_volume"] = cv
        out["single_frame_cvs"] = sfcv

        feats = self._feature_extractor(keyframe + 0.5)
        out["image_features"] = feats

        if cfg.pretrain_mode in (0, 2):
            cv_mask = self.att_module(sfcv, feats)
        elif cfg.pretrain_mode == 1:
            cv_mask = keyframe.new_zeros(b, 1, h, w)
        else:
            cv_mask = batch["mvobj_mask"]
        out["cv_mask"] = cv_mask

        if cfg.pretrain_mode == 2:
            out["result"] = cv_mask
            return out
        masked_cv = (1.0 - cv_mask) * cv
        out["cost_volume"] = masked_cv
        preds = self.depth(masked_cv, keyframe, feats)
        out["predicted_inverse_depths"] = preds
        out["result"] = preds[0]
        out["mask"] = cv_mask
        return out
