"""Binary PLY point clouds (``monorec_tpu/export/ply.py``), numpy.

Each valid pixel of an inverse-depth map is backprojected by its metric
depth, moved to the world frame by the cam-to-world pose and stored as an
``(x, y, z, r, g, b)`` float32 record; ``save`` writes them as binary
little-endian PLY. The depth range, the optional ROI and the random dropout
(from ``np.random.default_rng(seed)``) are the JAX package's, so identical
inputs give identical files.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class PLYWriter:
    def __init__(self, min_d: float = 3.0, max_d: float = 400.0,
                 roi: Optional[Sequence[int]] = None, dropout: float = 0.0, seed: int = 0):
        self.min_d = min_d
        self.max_d = max_d
        self.roi = roi
        self.dropout = dropout
        self._rng = np.random.default_rng(seed)
        self.records: List[np.ndarray] = []

    def add_depthmap(self, inv_depth: np.ndarray, image: np.ndarray, intrinsics: np.ndarray,
                     pose: np.ndarray) -> None:
        """``inv_depth`` (H, W) or (H, W, 1), ``image`` (H, W, 3) in [-0.5,
        0.5], ``intrinsics`` and ``pose`` (cam-to-world) 4x4."""
        inv_depth = np.asarray(inv_depth)
        if inv_depth.ndim == 3:
            inv_depth = inv_depth[..., 0]
        with np.errstate(divide="ignore"):
            depth = np.where(inv_depth > 0, 1.0 / inv_depth, np.inf)
        mask = (self.min_d <= depth) & (depth <= self.max_d)
        if self.roi is not None:
            t, b, l, r = self.roi
            roi_mask = np.zeros_like(mask)
            roi_mask[t:b, l:r] = True
            mask &= roi_mask
        if self.dropout > 0:
            mask &= self._rng.random(mask.shape) > self.dropout
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            return
        z = depth[ys, xs]
        fx, fy = intrinsics[0, 0], intrinsics[1, 1]
        cx, cy = intrinsics[0, 2], intrinsics[1, 2]
        pts = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z, np.ones_like(z)], axis=0)
        world = (pose @ pts)[:3].T
        rgb = (np.asarray(image)[ys, xs] + 0.5) * 255.0
        self.records.append(np.concatenate([world, rgb], axis=1).astype("<f4"))

    @property
    def num_points(self) -> int:
        return sum(len(r) for r in self.records)

    def save(self, file) -> None:
        header = (
            "ply\n"
            "format binary_little_endian 1.0\n"
            f"element vertex {self.num_points}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float red\nproperty float green\nproperty float blue\n"
            "end_header\n"
        )
        file.write(header.encode("ascii"))
        for rec in self.records:
            file.write(rec.tobytes())
