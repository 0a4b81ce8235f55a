"""Small shared utilities of the port (``monorec_tpu/utils``)."""

from monorec_tpu_torch.utils.core import (
    ValueFader,
    get_absolute_depth,
    get_mask,
    get_positive_depth,
    mask_mean,
    median_scaling,
    operator_on_dict,
    preprocess_roi,
)

__all__ = [
    "ValueFader",
    "get_absolute_depth",
    "get_mask",
    "get_positive_depth",
    "mask_mean",
    "median_scaling",
    "operator_on_dict",
    "preprocess_roi",
]
