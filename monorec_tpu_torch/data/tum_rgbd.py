"""TUM RGB-D reader of the port (``monorec_tpu/data/tum_rgbd.py``), in numpy:
every sample equals the JAX reader's. It matches the timestamps of
``rgb.txt``, ``depth.txt`` and ``groundtruth.txt`` (the nearest depth image
to each RGB image), interpolates the ground-truth poses at the RGB
timestamps (``data.pose_interp``), keeps the fixed freiburg3 intrinsics, and
turns the 16-bit depth PNGs into inverse depth with the scale 1.035 / 5000
(0 = invalid). 8-bit RGB and 16-bit greyscale PNGs go through
``data.png.read_png``, which gives PIL's arrays for both.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from monorec_tpu_torch.data.png import read_png
from monorec_tpu_torch.data.pose_interp import interpolate_poses, matrix_from_quat

_INTRINSICS = np.array(
    [[535.4, 0, 320.1, 0], [0, 539.2, 247.6, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)
_DEPTH_SCALE = 1.035 / 5000.0


def _load_file_times(path: Path) -> Tuple[np.ndarray, List[str]]:
    times, paths = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            t, p = line.split()[:2]
            times.append(float(t))
            paths.append(p)
    return np.asarray(times), paths


def _load_trajectory(path: Path) -> Tuple[np.ndarray, List[np.ndarray]]:
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(v) for v in line.split()])
    data = np.asarray(rows)
    times = data[:, 0]
    poses = []
    for row in data:
        m = np.eye(4)
        # groundtruth.txt quaternions are (x, y, z, w)
        qx, qy, qz, qw = row[4:8]
        m[:3, :3] = matrix_from_quat(np.array([qw, qx, qy, qz]))
        m[:3, 3] = row[1:4]
        poses.append(m)
    return times, poses


class TUMRGBDDataset:
    """Map-style TUM RGB-D dataset; arguments as the JAX reader's."""

    def __init__(
        self,
        dataset_dir: str,
        frame_count: int = 2,
        target_image_size: Tuple[int, int] = (480, 640),
        dilation: int = 1,
    ):
        self.root = Path(dataset_dir)
        self.frame_count = frame_count
        self.dilation = dilation
        self.target_image_size = tuple(target_image_size)

        rgb_times, self._rgb_paths = _load_file_times(self.root / "rgb.txt")
        depth_times, self._depth_paths = _load_file_times(self.root / "depth.txt")
        pose_times, poses = _load_trajectory(self.root / "groundtruth.txt")

        # Nearest-depth index per rgb frame.
        self._depth_index = np.abs(
            rgb_times[:, None] - depth_times[None, :]
        ).argmin(axis=1)
        self._poses = np.stack(
            interpolate_poses(pose_times, poses, rgb_times, rgb_times[0])
        ).astype(np.float32)

        self._offset = (frame_count // 2) * dilation
        self._length = len(rgb_times) - frame_count * dilation

    def __len__(self) -> int:
        return self._length

    def _image(self, i: int) -> np.ndarray:
        arr = read_png(self.root / self._rgb_paths[i]).astype(np.float32)
        return arr / 255.0 - 0.5

    def _depth(self, i: int) -> np.ndarray:
        arr = read_png(self.root / self._depth_paths[self._depth_index[i]]).astype(np.float64)
        with np.errstate(divide="ignore"):
            inv = np.where(arr > 0, 1.0 / (arr * _DEPTH_SCALE), 0.0)
        return inv[..., None].astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        off = self._offset
        rel = [
            i
            for i in range(0, (self.frame_count + 1) * self.dilation, self.dilation)
            if i != off
        ]
        sample = {
            "keyframe": self._image(index + off),
            "keyframe_pose": self._poses[index + off],
            "keyframe_intrinsics": _INTRINSICS,
            "frames": np.stack([self._image(index + i) for i in rel]),
            "poses": np.stack([self._poses[index + i] for i in rel]),
            "intrinsics": np.tile(_INTRINSICS[None], (len(rel), 1, 1)),
            "sequence": np.asarray([0], np.int32),
            "image_id": np.asarray([index + off], np.int32),
            "target": self._depth(index + off),
        }
        return sample
