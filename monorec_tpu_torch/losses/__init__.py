"""Losses of the port (``monorec_tpu/losses``)."""

from monorec_tpu_torch.losses.monorec_losses import LOSSES, depth_loss, mask_loss

__all__ = ["LOSSES", "depth_loss", "mask_loss"]
