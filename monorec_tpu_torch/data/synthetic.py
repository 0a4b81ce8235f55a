"""Synthetic data for the port, in numpy (NHWC arrays, the JAX package's
layout), and its conversion to the port's NCHW tensors:

* ``make_batch``: a twin of ``__graft_entry__._make_batch``, random images;
* ``SyntheticSweepDataset``: a twin of ``monorec_tpu/data/synthetic.py``,
  textured fronto-parallel planes at a known depth seen by a translating
  camera (``target = 1 / depth``).

Both give the same arrays as their JAX-package counterparts for the same
arguments, so tests feed the *same* numpy data to both packages; the port's
entry points feed it through ``batch_to_torch``.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
    """NHWC numpy batch -> NCHW tensors on ``device``; on CUDA through pinned
    memory with a non-blocking copy."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.asarray(value))
        if key in _IMAGE_KEYS:
            t = t.movedim(-1, -3)
        t = t.contiguous()
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


class SyntheticSweepDataset:
    """Textured fronto-parallel planes at a known depth, observed by a camera
    translating along x: every sample has an exactly known depth. Arguments
    as in ``monorec_tpu/data/synthetic.py`` (loader-only keys are ignored);
    samples are NHWC numpy dicts."""

    def __init__(self, length: int = 64, target_image_size: Tuple[int, int] = (64, 128),
                 frame_count: int = 2, depth_range: Tuple[float, float] = (4.0, 40.0),
                 baseline: float = 0.4, return_stereo: bool = False,
                 return_mvobj_mask: int = 0, seed: int = 0, **_: object):
        self.length = length
        self.size = tuple(target_image_size)
        self.frame_count = frame_count
        self.depth_range = depth_range
        self.baseline = baseline
        self.return_stereo = return_stereo
        self.return_mvobj_mask = int(return_mvobj_mask)
        self.seed = seed
        h, w = self.size
        self.fx = 0.8 * w
        k = np.zeros((4, 4), np.float32)
        k[0, 0] = k[1, 1] = self.fx
        k[0, 2], k[1, 2] = w / 2 - 0.5, h / 2 - 0.5
        k[2, 2] = k[3, 3] = 1.0
        self.k = k

    def __len__(self) -> int:
        return self.length

    def _render(self, phase: np.ndarray, depth: float, cam_x: float) -> np.ndarray:
        h, w = self.size
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        wx = (xs - self.k[0, 2]) / self.fx * depth + cam_x
        wy = (ys - self.k[1, 2]) / self.fx * depth
        img = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            img[..., c] = 0.35 * np.sin(wx * phase[c] + phase[c + 3]) * np.cos(
                wy * phase[c + 6] + phase[c + 9])
        return img

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.size
        depth = float(rng.uniform(*self.depth_range))
        phase = rng.uniform(0.5, 2.5, 12)
        half = self.frame_count // 2
        offsets = [i - half + (1 if i >= half else 0) for i in range(self.frame_count)]
        poses = np.tile(np.eye(4, dtype=np.float32), (self.frame_count, 1, 1))
        for i, o in enumerate(offsets):
            poses[i, 0, 3] = o * self.baseline
        sample = {
            "keyframe": self._render(phase, depth, 0.0),
            "keyframe_pose": np.eye(4, dtype=np.float32),
            "keyframe_intrinsics": self.k,
            "frames": np.stack([self._render(phase, depth, o * self.baseline) for o in offsets]),
            "poses": poses,
            "intrinsics": np.tile(self.k[None], (self.frame_count, 1, 1)),
            "sequence": np.asarray([0], dtype=np.int32),
            "image_id": np.asarray([index], dtype=np.int32),
            "target": np.full((h, w, 1), 1.0 / depth, np.float32),
        }
        if self.return_stereo:
            st = np.eye(4, dtype=np.float32)
            st[0, 3] = 0.54
            sample["stereoframe"] = self._render(phase, depth, 0.54)
            sample["stereoframe_pose"] = st
            sample["stereoframe_intrinsics"] = self.k
        if self.return_mvobj_mask:
            mask = np.zeros((h, w, 1), np.float32)
            mask[h // 4 : h // 2, w // 4 : w // 2] = 1.0
            sample["mvobj_mask"] = mask
            if self.return_mvobj_mask == 2:
                sample["target"] = mask
        return sample
