"""Operators of the port: the cost volume, its kernels, SSIM and sampling."""

from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    compute_cost_volume_pair,
)
from monorec_tpu_torch.ops.plane_sweep import (
    plane_sweep_cost_volume,
    plane_sweep_cost_volume_reference,
    plane_sweep_sad,
    plane_sweep_sad_reference,
)
from monorec_tpu_torch.ops.warp_sweep import warp_plane_sweep, warp_plane_sweep_reference

__all__ = [
    "CostVolumeConfig",
    "compute_cost_volume",
    "compute_cost_volume_pair",
    "plane_sweep_cost_volume",
    "plane_sweep_cost_volume_reference",
    "plane_sweep_sad",
    "plane_sweep_sad_reference",
    "warp_plane_sweep",
    "warp_plane_sweep_reference",
]
