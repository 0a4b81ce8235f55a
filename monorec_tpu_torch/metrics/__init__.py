"""Depth metrics of the port (``monorec_tpu/metrics``)."""

from monorec_tpu_torch.metrics.depth_metrics import METRIC_INPUTS, METRICS, get_metric

__all__ = ["METRIC_INPUTS", "METRICS", "get_metric"]
