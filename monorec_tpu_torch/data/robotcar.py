"""Oxford RobotCar reader of the port (``monorec_tpu/data/robotcar.py``), in
numpy and scipy: every sample equals the JAX reader's. It reads the RobotCar
SDK's layout without the SDK:

* the camera model from the SDK's ``models`` folder (``<camera>.txt``
  intrinsics, and an optional ``<camera>_distortion_lut.bin`` undistortion
  look-up table), ``stereo/centre`` being ``stereo_narrow_left``;
* 8-bit greyscale Bayer PNGs through ``data.png.read_png``, demosaiced with
  ``data.bayer.demosaic_gb2rgb`` (cv2's ``COLOR_BayerGB2RGB``, byte for
  byte) and undistorted through the LUT with
  ``scipy.ndimage.map_coordinates`` (bilinear, border-nearest) per channel;
* the JAX reader's lossy image chain: ``/ 256 - 0.5`` in float64, truncated
  back to uint8 as ``(x + 0.5) * 255``, Pillow's BILINEAR resize by
  ``scale`` (``data.resize.crop_resize_bilinear`` over the whole image),
  float32 ``/ 255 - 0.5``, then the ``cutout`` crop with the intrinsics
  scaled and shifted to match;
* the VO poses integrated from ``vo.csv`` and interpolated at the image
  timestamps (``data.pose_interp``), with the SDK's camera/world axis swap;
* LiDAR (``ldmrs/*.bin``) scans within +-``lidar_timestamp_range`` s of the
  keyframe projected into a sparse inverse-depth target, nearest returns
  written last: sorted by numpy's default (unstable) ``argsort`` of the
  inverse depth, as the JAX reader sorts, so where two returns share a
  pixel the same one wins.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from monorec_tpu_torch.data.bayer import demosaic_gb2rgb
from monorec_tpu_torch.data.png import read_png
from monorec_tpu_torch.data.pose_interp import interpolate_vo_poses, se3_from_xyzrpy
from monorec_tpu_torch.data.resize import crop_resize_bilinear

# Camera frame <-> world axis swap used by the reference (:18-23).
_SWAPAXES = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
)
_SWAPAXES_INV = np.linalg.inv(_SWAPAXES)


class CameraModel:
    """RobotCar camera model: intrinsics + optional undistortion LUT."""

    def __init__(self, models_dir: Path, images_dir: str):
        models_dir = Path(models_dir)
        self.camera = self._camera_name(images_dir)
        intr_path = models_dir / f"{self.camera}.txt"
        vals = np.loadtxt(intr_path, max_rows=1)
        self.focal_length = (float(vals[0]), float(vals[1]))
        self.principal_point = (float(vals[2]), float(vals[3]))

        lut_path = models_dir / f"{self.camera}_distortion_lut.bin"
        self._lut = None
        if lut_path.exists():
            lut = np.fromfile(lut_path, np.double)
            self._lut = lut.reshape(2, lut.size // 2)

    @staticmethod
    def _camera_name(images_dir: str) -> str:
        parts = Path(images_dir).parts
        if "stereo" in parts:
            side = parts[parts.index("stereo") + 1] if parts[-1] != "stereo" else "left"
            return f"stereo_wide_{side}" if side != "centre" else "stereo_narrow_left"
        return parts[-1]

    def undistort(self, image: np.ndarray) -> np.ndarray:
        if self._lut is None:
            return image
        h, w = image.shape[:2]
        lu = self._lut[0].reshape(h, w)
        lv = self._lut[1].reshape(h, w)
        from scipy.ndimage import map_coordinates

        if image.ndim == 2:
            return map_coordinates(image, [lv, lu], order=1, mode="nearest")
        chans = [
            map_coordinates(image[..., c], [lv, lu], order=1, mode="nearest")
            for c in range(image.shape[-1])
        ]
        return np.stack(chans, axis=-1)

    def project(
        self, points: np.ndarray, image_size: Tuple[float, float]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Project 4xN camera-frame points -> (2xM pixel coords, M depths)."""
        in_front = points[2, :] > 0
        pts = points[:, in_front]
        fx, fy = self.focal_length
        cx, cy = self.principal_point
        u = fx * pts[0] / pts[2] + cx
        v = fy * pts[1] / pts[2] + cy
        keep = (u >= 0.5) & (u < image_size[1] - 0.5) & (v >= 0.5) & (v < image_size[0] - 0.5)
        return np.stack([u[keep], v[keep]]), pts[2, keep]


def load_image(path: Path, model: Optional[CameraModel]) -> np.ndarray:
    """Load + demosaic + undistort a raw RobotCar image: (H, W, 3) float64
    in the uint8 range."""
    raw = read_png(path)
    if raw.ndim == 2:
        img = demosaic_gb2rgb(raw)
    else:
        img = raw
    if model is not None:
        img = model.undistort(img.astype(np.float64))
    return np.asarray(img, dtype=np.float64)


class OxfordRobotCarDataset:
    """Map-style RobotCar dataset; arguments as the JAX reader's. Samples
    are NHWC numpy dicts with its keys and dtypes."""

    def __init__(
        self,
        sequence_folders: Sequence[str],
        pose_files: Sequence[str],
        lidar_folders: Sequence[str],
        model_folder: str,
        extrinsics_folder: str,
        frame_count: int = 2,
        dilation: int = 1,
        scale: float = 0.25,
        cutout: Tuple[float, float, float, float] = (1 / 6, 1 / 6, 0, 0),
        lidar_timestamp_range: float = 0.5,
    ):
        self.sequence_folders = [Path(p) for p in sequence_folders]
        self.pose_files = [Path(p) for p in pose_files]
        self.lidar_folders = [Path(p) for p in lidar_folders]
        self.model_folder = Path(model_folder)
        self.extrinsics_folder = Path(extrinsics_folder)
        self.frame_count = frame_count
        self.dilation = dilation
        self.scale = scale
        self.cutout = cutout
        self.lidar_timestamp_range = lidar_timestamp_range
        self.target_image_size = (320, 640)

        self._offset = (frame_count // 2) * dilation
        self._files = [sorted(f.glob("[0-9]*.png")) for f in self.sequence_folders]
        self._timestamps = [[int(p.stem) for p in fs] for fs in self._files]
        self._models = [
            CameraModel(self.model_folder, str(f)) for f in self.sequence_folders
        ]
        self._poses = [
            [p @ _SWAPAXES for p in interpolate_vo_poses(pf, ts, min(ts))]
            for pf, ts in zip(self.pose_files, self._timestamps)
        ]
        self._lengths = [len(fs) - frame_count for fs in self._files]

        self._lidar_files = [sorted(f.glob("[0-9]*.bin")) for f in self.lidar_folders]
        self._lidar_ts = [[int(p.stem) for p in fs] for fs in self._lidar_files]
        self._lidar_poses = [
            interpolate_vo_poses(pf, ts, seq_ts[0])
            for pf, ts, seq_ts in zip(self.pose_files, self._lidar_ts, self._timestamps)
        ]
        self._lidar_tf = [self._extrinsic("ldmrs") for _ in self._models]
        self._camera_tf = [self._extrinsic(m.camera) for m in self._models]

    def _extrinsic(self, name: str) -> np.ndarray:
        with open(self.extrinsics_folder / f"{name}.txt") as f:
            vals = [float(v) for v in f.readline().split()]
        return se3_from_xyzrpy(vals)

    def __len__(self) -> int:
        return sum(self._lengths)

    def _locate(self, index: int) -> Tuple[int, int]:
        for si, n in enumerate(self._lengths):
            if index < n:
                return si, index
            index -= n
        raise IndexError(index)

    def _frame(self, si: int, i: int):
        img = load_image(self._files[si][i], self._models[si]) / 256.0 - 0.5
        h, w = img.shape[:2]
        sh, sw = int(h * self.scale), int(w * self.scale)
        img = crop_resize_bilinear(((img + 0.5) * 255).astype(np.uint8), (0, 0, w, h),
                                   (sh, sw)).astype(np.float32) / 255.0 - 0.5
        t, b, l, r = self.cutout
        full_h, full_w = img.shape[:2]
        img = img[
            int(t * full_h) : full_h - int(b * full_h),
            int(l * full_w) : full_w - int(r * full_w),
        ]
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = self._models[si].focal_length[0] * self.scale
        k[1, 1] = self._models[si].focal_length[1] * self.scale
        k[0, 2] = self._models[si].principal_point[0] * self.scale - l * full_w
        k[1, 2] = self._models[si].principal_point[1] * self.scale - t * full_h
        pose = self._poses[si][i].astype(np.float32)
        return img.astype(np.float32), pose, k

    def _depth(self, si: int, i: int, out_shape: Tuple[int, int]) -> np.ndarray:
        ts = self._timestamps[si][i]
        lo, hi = ts - self.lidar_timestamp_range * 1e6, ts + self.lidar_timestamp_range * 1e6
        cloud = [np.zeros((4, 1))]
        for li, lts in enumerate(self._lidar_ts[si]):
            if not (lo <= lts <= hi):
                continue
            scan = np.fromfile(self._lidar_files[si][li], np.double)
            scan = scan.reshape(len(scan) // 3, 3).T
            scan = (
                self._lidar_poses[si][li]
                @ self._lidar_tf[si]
                @ np.vstack([scan, np.ones((1, scan.shape[1]))])
            )
            cloud.append(scan)
        cloud = np.hstack(cloud)
        cam = (
            self._camera_tf[si]
            @ np.linalg.inv(self._poses[si][i] @ _SWAPAXES_INV)
            @ cloud
        )
        t, b, l, r = self.cutout
        full = (
            out_shape[0] / self.scale / (1 - t - b),
            out_shape[1] / self.scale / (1 - l - r),
        )
        uv, d = self._models[si].project(cam, full)
        uv = (uv * self.scale).astype(np.int64)
        with np.errstate(divide="ignore"):
            inv_d = 1.0 / d
        order = np.argsort(inv_d)
        uv, inv_d = uv[:, order], inv_d[order]
        H = round(out_shape[0] / (1 - t - b))
        W = round(out_shape[1] / (1 - l - r))
        depth = np.zeros((H, W), np.float32)
        valid = (uv[1] < H) & (uv[0] < W) & (uv[1] >= 0) & (uv[0] >= 0)
        depth[uv[1, valid], uv[0, valid]] = inv_d[valid]
        depth = depth[int(t * H) : H - int(b * H), int(l * W) : W - int(r * W)]
        return depth[..., None]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        si, i = self._locate(index)
        off = self._offset
        keyframe, kpose, kintr = self._frame(si, i + off)

        frames, poses, intr = [], [], []
        for j in range(-self.frame_count // 2, (self.frame_count + 1) // 2 + 1):
            if j == 0:
                continue
            fr, po, ki = self._frame(si, i + off + j * self.dilation)
            frames.append(fr)
            poses.append(po)
            intr.append(ki)

        return {
            "keyframe": keyframe,
            "keyframe_pose": kpose,
            "keyframe_intrinsics": kintr,
            "frames": np.stack(frames),
            "poses": np.stack(poses),
            "intrinsics": np.stack(intr),
            "sequence": np.asarray([si], np.int32),
            "image_id": np.asarray([i + off], np.int32),
            "target": self._depth(si, i + off, keyframe.shape[:2]).astype(np.float32),
        }
