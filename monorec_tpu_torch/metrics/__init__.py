"""Depth metrics of the port (``monorec_tpu/metrics``)."""

from monorec_tpu_torch.metrics.depth_metrics import METRICS, get_metric

__all__ = ["METRICS", "get_metric"]
