"""Synthetic batches for the port: a numpy twin of
``__graft_entry__._make_batch`` (NHWC numpy arrays, the JAX package's
layout) and its conversion to the port's NCHW tensors.

Tests feed the *same* numpy batch to both packages; the port's entry
points feed it through ``batch_to_torch``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Image-like entries: channels last in the numpy batch, moved to dim -3.
_IMAGE_KEYS = ("keyframe", "frames", "stereoframe", "mvobj_mask", "target")


def make_batch(b: int, h: int, w: int, f: int, stereo: bool = True, mask: bool = True,
               seed: int = 0, tz: float = 0.0) -> Dict[str, np.ndarray]:
    """Random images in [-0.5, 0.5], pinhole intrinsics (f = 0.8 W) and
    source frames 0.3 m apart along x; ``tz > 0`` adds KITTI-like forward
    motion (~1 m/frame at 10 fps). Same draws as ``_make_batch``."""
    rng = np.random.default_rng(seed)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
    k[2, 2] = k[3, 3] = 1.0
    kb = np.tile(k, (b, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    for i in range(f):
        poses[:, i, 0, 3] = 0.3 * (i - f / 2 + 0.5)
        poses[:, i, 2, 3] = tz * (i - f / 2 + 0.5) * 2

    batch = {
        "keyframe": rng.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32),
        "keyframe_pose": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "keyframe_intrinsics": kb,
        "frames": rng.uniform(-0.5, 0.5, (b, f, h, w, 3)).astype(np.float32),
        "poses": poses,
        "intrinsics": np.tile(kb[:, None], (1, f, 1, 1)),
        "target": rng.uniform(0.01, 0.3, (b, h, w, 1)).astype(np.float32),
    }
    sp = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    sp[:, 0, 3] = 0.54
    if stereo:
        batch["stereoframe"] = rng.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32)
        batch["stereoframe_pose"] = sp
        batch["stereoframe_intrinsics"] = kb
    if mask:
        batch["mvobj_mask"] = (rng.uniform(0, 1, (b, h, w, 1)) > 0.9).astype(np.float32)
    return batch


def batch_to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """NHWC numpy batch -> NCHW float tensors on ``device``."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.asarray(value))
        if key in _IMAGE_KEYS:
            t = t.movedim(-1, -3)
        out[key] = t.contiguous().to(device)
    return out
