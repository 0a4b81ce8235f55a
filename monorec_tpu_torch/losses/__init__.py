"""Losses of the port (``monorec_tpu/losses``)."""

from monorec_tpu_torch.losses.monorec_losses import (
    LOSSES,
    depth_aux_mask_loss,
    depth_loss,
    depth_refinement_loss,
    mask_loss,
    mask_refinement_loss,
)
from monorec_tpu_torch.losses.perceptual import PerceptualError

__all__ = ["LOSSES", "PerceptualError", "depth_aux_mask_loss", "depth_loss",
           "depth_refinement_loss", "mask_loss", "mask_refinement_loss"]
