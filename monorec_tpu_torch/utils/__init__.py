"""Small shared utilities of the port (``monorec_tpu/utils``)."""

from monorec_tpu_torch.utils.core import (
    Timer,
    ValueFader,
    dilate_mask,
    get_absolute_depth,
    get_mask,
    get_positive_depth,
    mask_mean,
    masked_where,
    median_scaling,
    operator_on_dict,
    pose_distance_thresh,
    preprocess_roi,
    save_frame_for_tsdf,
    save_intrinsics_for_tsdf,
)

__all__ = [
    "Timer",
    "ValueFader",
    "dilate_mask",
    "get_absolute_depth",
    "get_mask",
    "get_positive_depth",
    "mask_mean",
    "masked_where",
    "median_scaling",
    "operator_on_dict",
    "pose_distance_thresh",
    "preprocess_roi",
    "save_frame_for_tsdf",
    "save_intrinsics_for_tsdf",
]
