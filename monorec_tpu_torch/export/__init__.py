"""Point-cloud export of the port (``monorec_tpu/export``)."""

from monorec_tpu_torch.export.ply import PLYWriter
from monorec_tpu_torch.export.pointcloud import export_pointcloud, pointcloud_masks

__all__ = ["PLYWriter", "export_pointcloud", "pointcloud_masks"]
