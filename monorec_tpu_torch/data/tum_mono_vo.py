"""TUM mono VO reader of the port (``monorec_tpu/data/tum_mono_vo.py``), in
numpy: every sample equals the JAX reader's (the colour-jittered images
within float rounding). It reads DSO ``result.txt`` trajectories (timestamp,
translation, xyzw quaternion) matched to the frames of ``times.txt``, the
relative intrinsics of ``camera.txt`` (a model name may come before the
numbers), and inverts the photometric calibration of ``pcalib.txt``. Each
JPEG, greyscale or colour, goes through ``data.jpeg.read_jpeg`` (PIL's
bytes), the centre crop to the target's aspect and Pillow's bilinear
resize (``data.resize.crop_resize_bilinear``; a greyscale image resized
once and replicated to three channels, PIL's ``convert("RGB")``), then the
per-sample colour jitter and the calibration lookup on 0..255 levels. The
original size comes from the frame header (``data.jpeg.jpeg_size``). Also
the multi-directory wrapper.

Depth comes from ``images_depth/<frame>_d.exr`` where that file exists
(zeros where it does not), read by ``data.exr.read_exr`` (what cv2 returns
where it is built with OpenEXR), its first channel of three, cropped by the
image's crop box, then max-pooled 2x2 where the cropped height is twice
the target's, else resized with Pillow's float bilinear
(``data.resize.resize_bilinear_float``), and clamped at 0.
``only_keyframes`` takes the frames with a depth file as keyframes, by the
files' names. Where the JAX reader's cv2 cannot decode a file it gives
zeros; the port raises naming why.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from monorec_tpu_torch.data.color_jitter import apply_color_jitter, sample_color_jitter
from monorec_tpu_torch.data.exr import read_exr
from monorec_tpu_torch.data.jpeg import jpeg_size, read_jpeg
from monorec_tpu_torch.data.kitti import compute_crop_and_intrinsics
from monorec_tpu_torch.data.pose_interp import matrix_from_quat
from monorec_tpu_torch.data.resize import crop_resize_bilinear, resize_bilinear_float


class TUMMonoVODataset:
    """Map-style TUM mono VO dataset; arguments as the JAX reader's."""

    def __init__(
        self,
        dataset_dir: str,
        frame_count: int = 2,
        target_image_size: Tuple[int, int] = (480, 640),
        max_length: Optional[int] = None,
        dilation: int = 1,
        only_keyframes: bool = False,
        color_augmentation: bool = True,
        scale_factor: float = 1.0,
        seed: int = 0,
    ):
        self.root = Path(dataset_dir)
        self.frame_count = frame_count
        self.dilation = dilation
        self.target_image_size = tuple(target_image_size)
        self.only_keyframes = only_keyframes
        self.color_augmentation = color_augmentation
        self.scale_factor = scale_factor
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()  # a loader's workers draw one at a time

        self._result = np.loadtxt(self.root / "result.txt")
        self._times = np.loadtxt(self.root / "times.txt")
        self._inv_pcalib = self._invert_pcalib(np.loadtxt(self.root / "pcalib.txt"))
        self._image_index = self._build_image_index()

        self._offset = (frame_count // 2) * dilation
        if only_keyframes:
            self._keyframe_index = self._build_keyframe_index()
            self.length = len(self._keyframe_index)
        else:
            self.length = self._result.shape[0] - frame_count * dilation
            if max_length is not None:
                self.length = min(self.length, max_length)

        ow, oh = jpeg_size(self.root / "images" / "00000.jpg")
        proj = self._load_intrinsics((oh, ow))
        self._crop_box, self._intrinsics = compute_crop_and_intrinsics(
            proj, (oh, ow), self.target_image_size
        )
        self._poses = self._build_poses()

    # ------------------------------------------------------------------

    def _load_intrinsics(self, orig_size) -> np.ndarray:
        path = self.root / "camera.txt"
        with open(path) as f:
            first = f.readline().split()
        vals = [float(v) for v in (first[:4] if first[0][0].isdigit() else first[1:5])]
        oh, ow = orig_size
        proj = np.zeros((3, 4))
        proj[0, 0] = vals[0] * ow
        proj[1, 1] = vals[1] * oh
        proj[0, 2] = vals[2] * ow
        proj[1, 2] = vals[3] * oh
        proj[2, 2] = 1
        return proj

    @staticmethod
    def _invert_pcalib(pcalib: np.ndarray) -> np.ndarray:
        inv = np.zeros(256, dtype=np.float32)
        j = 0
        for i in range(256):
            while j < 255 and i + 0.5 > pcalib[j]:
                j += 1
            inv[i] = j
        return inv

    def _build_image_index(self) -> np.ndarray:
        eps = 1e-5
        idx = np.zeros(self._result.shape[0], dtype=np.int64)
        cur = 0
        for i in range(self._result.shape[0]):
            ts = self._result[i, 0]
            while not ts <= self._times[cur, 1] + eps:
                cur += 1
            idx[i] = cur
        return idx

    def _build_keyframe_index(self) -> np.ndarray:
        out = []
        pos = 0
        for p in sorted((self.root / "images_depth").glob("*.exr")):
            img_i = int(p.stem[:5])
            while pos < len(self._image_index) and self._image_index[pos] < img_i:
                pos += 1
            lo = (self.frame_count // 2) * self.dilation
            hi = len(self._image_index) - (self.frame_count // 2 + 1) * self.dilation
            if lo <= pos < hi:
                out.append(pos)
        return np.asarray(out)

    def _build_poses(self) -> np.ndarray:
        n = self._result.shape[0]
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i in range(n):
            qx, qy, qz, qw = self._result[i, 4:8]
            poses[i, :3, :3] = matrix_from_quat(np.array([qw, qx, qy, qz]))
            poses[i, :3, 3] = self._result[i, 1:4] * self.scale_factor
        return poses

    def _image(self, i: int, jitter) -> np.ndarray:
        path = self.root / "images" / f"{self._image_index[i]:05d}.jpg"
        img = crop_resize_bilinear(read_jpeg(path), self._crop_box, self.target_image_size)
        if img.ndim == 2:
            # The channels of convert("RGB") are equal: resize once, then copy.
            img = np.repeat(img[..., None], 3, axis=-1)
        arr = img.astype(np.float32) / 255.0
        if jitter is not None:
            arr = apply_color_jitter(arr, jitter)
        # Photometric calibration inversion on 0..255 levels.
        levels = np.clip(arr * 255.0, 0, 255).astype(np.int64)
        arr = self._inv_pcalib[levels] / 255.0 - 0.5
        return arr.astype(np.float32)

    def _depth(self, i: int) -> np.ndarray:
        th, tw = self.target_image_size
        p = self.root / "images_depth" / f"{self._image_index[i]:05d}_d.exr"
        if not p.is_file():
            return np.zeros((th, tw, 1), np.float32)
        d = read_exr(p)
        if d.ndim == 3:
            d = d[..., 0]
        l, t, r, b = self._crop_box
        d = d[t:b, l:r]
        if d.shape[0] == 2 * th:
            d = d.reshape(th, 2, tw, 2).max(axis=(1, 3))
        else:
            d = resize_bilinear_float(d, (th, tw))
        d = np.maximum(d, 0.0)
        return d[..., None].astype(np.float32)

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        off = self._offset
        if self.only_keyframes:
            index = int(self._keyframe_index[index]) - off
        jitter = None
        if self.color_augmentation:
            with self._rng_lock:
                jitter = sample_color_jitter(self._rng)

        rel = [
            i
            for i in range(0, (self.frame_count + 1) * self.dilation, self.dilation)
            if i != off
        ]
        return {
            "keyframe": self._image(index + off, jitter),
            "keyframe_pose": self._poses[index + off],
            "keyframe_intrinsics": self._intrinsics,
            "frames": np.stack([self._image(index + i, jitter) for i in rel]),
            "poses": np.stack([self._poses[index + i] for i in rel]),
            "intrinsics": np.tile(self._intrinsics[None], (len(rel), 1, 1)),
            "sequence": np.asarray([0], np.int32),
            "image_id": np.asarray([index + off], np.int32),
            "target": self._depth(index + off),
        }


class TUMMonoVOMultiDataset:
    """Concatenation over several sequence directories (reference :14-35)."""

    def __init__(self, dataset_dirs, **kwargs):
        dirs = dataset_dirs if isinstance(dataset_dirs, list) else [dataset_dirs]
        self.datasets = [TUMMonoVODataset(d, **kwargs) for d in dirs]
        self.target_image_size = self.datasets[0].target_image_size

    def __getitem__(self, index: int):
        for ds in self.datasets:
            if index < len(ds):
                return ds[index]
            index -= len(ds)
        raise IndexError(index)

    def __len__(self):
        return sum(len(d) for d in self.datasets)
