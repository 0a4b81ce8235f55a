"""Masked reductions, ROI and depth helpers, median scaling, value faders,
the pose-spread check, mask dilation and the TSDF export
(``monorec_tpu/utils/core.py``), on NCHW tensors."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as tnf

from monorec_tpu_torch.data.jpeg_encoder import write_jpeg
from monorec_tpu_torch.data.png import write_png
from monorec_tpu_torch.parallel import ratio_of_sums

Tensor = torch.Tensor


def mask_mean(t: Tensor, invalid: Tensor, dim=None) -> Tensor:
    """Mean of ``t`` over entries where ``invalid`` is False.

    The denominator is (element count - #invalid), as in the reference
    (``utils/util.py:110-118``), so an all-invalid reduction divides by zero
    and yields NaN, which callers guard as the reference does. With
    ``dim=None`` it couples the samples: under a sharded batch the sum and
    the count are the global batch's (``parallel.ratio_of_sums``), so a
    shard with no valid entry is NaN only where the global batch is.
    """
    invalid = torch.broadcast_to(invalid, t.shape)
    t = torch.where(invalid, 0.0, t)
    if dim is None:
        return ratio_of_sums(t.sum(), t.numel() - invalid.sum().to(t.dtype))
    dims = tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)
    total = 1
    for d in dims:
        total *= t.shape[d]
    return t.sum(dim=dims) / (total - invalid.sum(dim=dims).to(t.dtype))


def masked_where(invalid: Tensor, t: Tensor, fill: float = 0.0) -> Tensor:
    return torch.where(torch.broadcast_to(invalid, t.shape), fill, t)


def preprocess_roi(pred, gt: Tensor, roi: Optional[Sequence[int]]):
    """Crop NCHW prediction(s) and GT to a region of interest [t, b, l, r]."""
    if roi is None:
        return pred, gt
    t, b, l, r = roi
    crop = lambda x: x[:, :, t:b, l:r]  # noqa: E731
    if isinstance(pred, list):
        return [crop(p) for p in pred], crop(gt)
    return crop(pred), crop(gt)


def get_positive_depth(pred, gt: Tensor):
    if isinstance(pred, list):
        return [torch.relu(p) for p in pred], torch.relu(gt)
    return torch.relu(pred), torch.relu(gt)


def get_absolute_depth(pred, gt: Tensor, max_distance: Optional[float] = None):
    """Inverse depth -> metric depth with an optional far clamp."""
    if max_distance is not None:
        clamp = 1.0 / max_distance
        if isinstance(pred, list):
            pred = [torch.clamp_min(p, clamp) for p in pred]
        else:
            pred = torch.clamp_min(pred, clamp)
        gt = torch.clamp_min(gt, clamp)
    if isinstance(pred, list):
        return [1.0 / p for p in pred], 1.0 / gt
    return 1.0 / pred, 1.0 / gt


def get_mask(pred: Tensor, gt: Tensor, max_distance: Optional[float] = None,
             pred_all_valid: bool = True) -> Tensor:
    """Invalid-pixel mask for sparse metrics (gt == 0, too-far gt, optionally
    pred == 0)."""
    mask = gt == 0
    if max_distance:
        mask = mask | (gt < 1.0 / max_distance)
    if not pred_all_valid:
        mask = mask | (pred == 0)
    return mask


def median_scaling(result: Tensor, target: Tensor) -> Tensor:
    """``result`` scaled per sample by median(target) / median(result), both
    medians over the pixels with target > 0 (``monorec_tpu/utils/core.py``).
    The median is the JAX package's: the mean of the two middle values of
    the sorted valid pixels (one value when their count is odd); a sample
    with no valid pixel gets inf / inf = NaN."""
    b = result.shape[0]
    valid = (target > 0).reshape(b, -1)
    n_valid = valid.sum(1, keepdim=True)
    lo = ((n_valid - 1) // 2).clamp_min(0)
    hi = n_valid // 2

    def masked_median(x):
        s = torch.where(valid, x.reshape(b, -1), torch.inf).sort(dim=1).values
        return (s.gather(1, lo) + s.gather(1, hi)) / 2.0

    ratio = masked_median(target) / masked_median(result)
    return result * ratio.reshape((b,) + (1,) * (result.dim() - 1))


class ValueFader:
    """Piecewise-linear schedule over epochs (reference ``ValueFader``)."""

    def __init__(self, steps: List[float], values: List[float]):
        self.steps = steps
        self.values = values

    def get_value(self, epoch: float) -> float:
        if epoch >= self.steps[-1]:
            return self.values[-1]
        i = 0
        while i < len(self.steps) - 1 and epoch >= self.steps[i + 1]:
            i += 1
        p = (epoch - self.steps[i]) / float(self.steps[i + 1] - self.steps[i])
        return (1 - p) * self.values[i] + p * self.values[i + 1]


class Timer:
    def __init__(self):
        self._t = time.monotonic()

    def check(self) -> float:
        now = time.monotonic()
        dt = now - self._t
        self._t = now
        return dt

    def reset(self):
        self._t = time.monotonic()


def operator_on_dict(d0: Dict, d1: Dict, op, default=0):
    keys = set(d0) | set(d1)
    return {k: op(d0.get(k, default), d1.get(k, default)) for k in keys}


def pose_distance_thresh(keyframe_pose: Tensor, frame_poses: Tensor, spatial_thresh: float = 0.6,
                         rotational_thresh: float = 0.05) -> Tensor:
    """Per sample, whether the window spans enough motion (reference
    ``pose_distance_thresh``, ``utils/util.py:217-222``): the spread of the
    camera centres over the keyframe (B, 4, 4) and its frames (B, F, 4, 4),
    or the spread of their forward directions ``R[:, 2]``, over its
    threshold. (B,) bool."""
    poses = torch.cat([keyframe_pose[:, None], frame_poses], dim=1)

    def spread(v):
        d = v.amax(dim=1) - v.amin(dim=1)
        return (d * d).sum(dim=-1).sqrt()

    return ((spread(poses[..., :3, 3]) > spatial_thresh)
            | (spread(poses[..., :3, 2]) > rotational_thresh))


def dilate_mask(mask: Tensor, size: int = 15) -> Tensor:
    """Binary dilation of a (B, C, H, W) mask (kept where >= 0.5) with a
    size x size box (reference ``dilate_mask``, ``utils/util.py:225-228``):
    the box reaches ``size // 2`` pixels up and left and ``size - 1 - size //
    2`` down and right. Bool, the shape of ``mask``."""
    binary = (mask >= 0.5).float()
    pad = size // 2
    padded = tnf.pad(binary, (pad, size - 1 - pad, pad, size - 1 - pad))
    return tnf.max_pool2d(padded, size, stride=1) > 0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_frame_for_tsdf(dir_path, index, keyframe, inv_depth, pose, crop=None,
                        min_distance=None, max_distance=None) -> None:
    """Export one frame in the colour / depth / pose layout TSDF fusion tools
    read (reference ``save_frame_for_tsdf``, ``utils/util.py:78-91``):
    ``frame-{index:06d}.color.jpg``, ``.depth.png`` (depth in cm, 16 bits)
    and ``.pose.txt`` (world to camera) in ``dir_path``.

    ``keyframe`` (3, H, W) in [-0.5, 0.5], ``inv_depth`` (1, H, W) or (H, W),
    ``pose`` (4, 4) camera to world: tensors on any device, or arrays. They
    are moved to the host and converted there in numpy, as the JAX package
    does: a depth past the int32 range (a tiny or subnormal inverse depth)
    casts to INT_MIN on the host and is written as 0, where a cast on the
    card would saturate. The files are PIL's bytes (``write_jpeg``) and
    Pillow 12's mode-"I" PNG, the depth clipped to [0, 65535]
    (``write_png``)."""
    dir_path = Path(dir_path)
    keyframe = _host(keyframe).transpose(1, 2, 0)
    inv_depth = _host(inv_depth)
    inv_depth = inv_depth.reshape(inv_depth.shape[-2:])
    pose = _host(pose)
    if crop is not None:
        t, b, l, r = crop
        keyframe = keyframe[t:b, l:r]
        inv_depth = inv_depth[t:b, l:r]
    rgb = ((keyframe + 0.5) * 255).clip(0, 255).astype(np.uint8)
    # A subnormal inverse depth overflows to inf, and inf casts to INT_MIN.
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        depth_cm = np.where(inv_depth > 0, 100.0 / inv_depth, 0.0)
        depth_cm = np.where(depth_cm < 0, 0, depth_cm)
        if min_distance is not None:
            depth_cm = np.where(depth_cm < min_distance * 100, 0, depth_cm)
        if max_distance is not None:
            depth_cm = np.where(depth_cm > max_distance * 100, 0, depth_cm)
        depth_cm = depth_cm.astype(np.int32)
    write_jpeg(dir_path / f"frame-{index:06d}.color.jpg", rgb)
    write_png(dir_path / f"frame-{index:06d}.depth.png",
              np.clip(depth_cm, 0, 65535).astype(np.uint16))
    np.savetxt(dir_path / f"frame-{index:06d}.pose.txt", np.linalg.inv(pose))


def save_intrinsics_for_tsdf(dir_path, intrinsics, crop=None) -> None:
    """``camera-intrinsics.txt`` in ``dir_path``: the 3x3 of ``intrinsics``
    with the principal point shifted by the crop [t, b, l, r] (reference
    ``save_intrinsics_for_tsdf``, ``utils/util.py:94-98``)."""
    k = _host(intrinsics).copy()
    if crop is not None:
        k[0, 2] -= crop[2]
        k[1, 2] -= crop[0]
    np.savetxt(Path(dir_path) / "camera-intrinsics.txt", k[:3, :3])
