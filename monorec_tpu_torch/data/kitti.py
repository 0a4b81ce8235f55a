"""KITTI Odometry reader of the port (``monorec_tpu/data/kitti.py``), in
numpy: PNGs through ``data.png.read_png`` and the crop and resize through
``data.resize.crop_resize_bilinear``, which give the bytes PIL gives, so
every sample equals the JAX reader's.

The layout is the KITTI Odometry one::

    <root>/sequences/<seq>/{calib.txt, image_2/, image_3/, <depth_folder>/}
    <root>/poses/<seq>.txt          (or poses_dvso/<seq>.txt)

* the temporal window: ``frame_count`` source frames around the keyframe,
  ``dilation`` apart and shifted by ``offset_d``;
* the centre crop to the target's aspect and the bilinear resize, with the
  intrinsics rescaled to match;
* inverse-depth GT (0 = invalid) from annotated LiDAR PNGs (value / 256 m),
  dense LiDAR ``.npz`` maps (``scipy.sparse``), dense ``.npy`` maps, or DSO
  PNGs (scale 0.54 fx 65535);
* the stereo frame (cam 3) at the baseline's pose, moving-object masks,
  JSON index masks, and the per-sample colour jitter applied alike to every
  frame of a sample.

Samples are NHWC numpy dicts with the JAX reader's keys and dtypes;
``data.synthetic.batch_to_torch`` moves a batch of them to the device.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from monorec_tpu_torch.data.color_jitter import apply_color_jitter, sample_color_jitter
from monorec_tpu_torch.data.png import png_size, read_png
from monorec_tpu_torch.data.resize import crop_resize_bilinear


def load_calib(path: Path) -> Dict[str, np.ndarray]:
    """The 3x4 matrices of a ``calib.txt`` (P0-P3, Tr) by name."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.array([float(v) for v in vals.split()], dtype=np.float64)
            if arr.size == 12:
                out[key.strip()] = arr.reshape(3, 4)
    return out


def load_poses(path: Path) -> np.ndarray:
    """(N, 4, 4) cam-to-world poses from a KITTI odometry poses file."""
    data = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4, dtype=np.float64), (data.shape[0], 1, 1))
    poses[:, :3, :] = data
    return poses.astype(np.float32)


def compute_crop_and_intrinsics(proj: np.ndarray, orig_size: Tuple[int, int],
                                target_size: Tuple[int, int]
                                ) -> Tuple[Tuple[int, int, int, int], np.ndarray]:
    """The centre crop box (l, t, r, b) to the target's aspect and the 4x4
    intrinsics in target pixels."""
    oh, ow = orig_size
    th, tw = target_size
    if oh / ow >= th / tw:  # too tall: crop rows
        new_h = th / tw * ow
        top = (oh - new_h) // 2
        box = (0, int(top), ow, int(oh - top))
        cx, cy = proj[0, 2], proj[1, 2] - (oh - new_h) / 2
        scale = tw / ow
    else:  # too wide: crop columns (KITTI)
        new_w = oh / (th / tw)
        left = (ow - new_w) // 2
        box = (int(left), 0, int(ow - left), oh)
        cx, cy = proj[0, 2] - (ow - new_w) / 2, proj[1, 2]
        scale = th / oh
    k = np.zeros((4, 4), dtype=np.float32)
    k[0, 0] = proj[0, 0] * scale
    k[1, 1] = proj[1, 1] * scale
    k[0, 2] = cx * scale
    k[1, 2] = cy * scale
    k[2, 2] = k[3, 3] = 1.0
    return box, k


def scatter_sparse_depth(rows: np.ndarray, cols: np.ndarray, inv_depth: np.ndarray,
                         src_size: Tuple[int, int],
                         crop_box: Optional[Tuple[int, int, int, int]],
                         target_size: Tuple[int, int]) -> np.ndarray:
    """Sparse inverse-depth samples scattered into a target-size map (the
    nearest target pixel; a later sample overwrites an earlier one)."""
    th, tw = target_size
    rows = rows.astype(np.float64)
    cols = cols.astype(np.float64)
    if crop_box is not None:
        l, t, r, b = crop_box
        keep = (t <= rows) & (rows < b) & (l <= cols) & (cols < r)
        rows, cols, inv_depth = rows[keep] - t, cols[keep] - l, inv_depth[keep]
        ch, cw = b - t, r - l
    else:
        ch, cw = src_size
    rr = np.clip(rows / ch * th, 0, th - 1)
    cc = np.clip(cols / cw * tw, 0, tw - 1)
    out = np.zeros(target_size, dtype=np.float32)
    out[np.around(rr).astype(np.int64), np.around(cc).astype(np.int64)] = inv_depth
    return out


def _nearest_crop(dense: np.ndarray, box, target_size) -> np.ndarray:
    """The nearest-neighbour resize of ``dense`` cropped to ``box``."""
    l, t, r, b = box
    dense = dense[t:b, l:r]
    th, tw = target_size
    ys = (np.arange(th) * dense.shape[0] // th).astype(np.int64)
    xs = (np.arange(tw) * dense.shape[1] // tw).astype(np.int64)
    return dense[ys][:, xs]


class KittiOdometryDataset:
    """Map-style KITTI Odometry dataset; arguments as the JAX reader's."""

    def __init__(
        self,
        dataset_dir: str,
        frame_count: int = 2,
        sequences: Optional[Sequence[str]] = None,
        depth_folder: str = "image_depth",
        target_image_size: Tuple[int, int] = (256, 512),
        max_length: Optional[int] = None,
        dilation: int = 1,
        offset_d: int = 0,
        use_color: bool = True,
        use_dso_poses: bool = False,
        use_color_augmentation: bool = False,
        lidar_depth: bool = False,
        dso_depth: bool = True,
        annotated_lidar: bool = True,
        return_stereo: bool = False,
        return_mvobj_mask: int = 0,
        use_index_mask: Optional[Sequence[str]] = (),
        custom_length: Optional[int] = None,
        seed: int = 0,
    ):
        self.root = Path(dataset_dir)
        self.frame_count = frame_count
        self.depth_folder = depth_folder
        self.target_image_size = tuple(target_image_size)
        self.dilation = dilation
        self.offset_d = offset_d
        self.use_color = use_color
        self.use_color_augmentation = use_color_augmentation
        self.lidar_depth = lidar_depth
        self.dso_depth = dso_depth
        self.annotated_lidar = annotated_lidar
        self.return_stereo = return_stereo
        self.return_mvobj_mask = int(return_mvobj_mask)
        self._rng = np.random.default_rng(seed)
        # np.random.Generator is not thread-safe: a loader's workers take
        # their draws one at a time (in the order the threads arrive, as in
        # the JAX package).
        self._rng_lock = threading.Lock()
        self._rel = [i for i in range(-(frame_count // 2) * dilation,
                                      ((frame_count + 1) // 2) * dilation + 1, dilation)
                     if i != 0]
        self.sequences = (list(sequences) if sequences is not None
                          else [f"{i:02d}" for i in range(11)])

        self._offset = (frame_count // 2) * dilation
        extra = frame_count * dilation
        if annotated_lidar and lidar_depth:
            # The annotated depth maps leave out the first and last 5 frames.
            extra = max(extra, 10)
            self._offset = max(self._offset, 5)

        cam = "image_2" if use_color else "image_0"
        pose_dir = "poses_dvso" if use_dso_poses else "poses"
        self._calibs, self._poses, self._crop_boxes, self._intrinsics = {}, {}, {}, {}
        self._num_images, self._orig_sizes, self._baselines = {}, {}, {}
        for seq in self.sequences:
            seq_dir = self.root / "sequences" / seq
            calib = load_calib(seq_dir / "calib.txt")
            img_files = sorted((seq_dir / cam).glob("*.png"))
            if not img_files:
                raise FileNotFoundError(f"no images in {seq_dir / cam}")
            ow, oh = png_size(img_files[0])
            box, k = compute_crop_and_intrinsics(calib["P2"] if use_color else calib["P0"],
                                                 (oh, ow), self.target_image_size)
            self._calibs[seq] = calib
            self._crop_boxes[seq] = box
            self._intrinsics[seq] = k
            self._orig_sizes[seq] = (oh, ow)
            # The highest image number + 1: a sequence's folder may be sparse.
            self._num_images[seq] = int(img_files[-1].stem) + 1
            self._poses[seq] = load_poses(self.root / pose_dir / f"{seq}.txt")
            if return_stereo:
                p2, p3 = calib["P2"], calib["P3"]
                self._baselines[seq] = float(abs(p3[0, 3] / p3[0, 0] - p2[0, 3] / p2[0, 0]))

        self._sizes: List[int] = []
        self._indices: Optional[List[List[int]]] = None
        if use_index_mask:
            self._indices = []
            for seq in self.sequences:
                n = self._num_images[seq]
                allowed = range(n)
                for mask_name in use_index_mask:
                    with open(self.root / "sequences" / seq / f"{mask_name}.json") as f:
                        m = json.load(f)
                    allowed = [i for i in allowed if m.get(str(i))]
                idx = sorted(i for i in allowed if self._offset <= i < n - extra + self._offset)
                self._indices.append(idx)
                self._sizes.append(len(idx))
        else:
            self._sizes = [self._num_images[seq] - extra for seq in self.sequences]
        if custom_length is not None:
            self._sizes = [custom_length] + self._sizes[1:]
        if max_length is not None:
            self._sizes = [min(s, max_length) for s in self._sizes]
        self.length = sum(self._sizes)

    def __len__(self) -> int:
        return self.length

    def _locate(self, index: int) -> Tuple[int, int]:
        for i, size in enumerate(self._sizes):
            if index < size:
                return i, index
            index -= size
        raise IndexError(index)

    def _image_path(self, seq: str, i: int, stereo: bool = False) -> Path:
        cam = ("image_3" if stereo else "image_2") if self.use_color else (
            "image_1" if stereo else "image_0")
        return self.root / "sequences" / seq / cam / f"{i:06d}.png"

    def _load_image(self, path: Path, seq: str, jitter=None) -> np.ndarray:
        img = crop_resize_bilinear(read_png(path), self._crop_boxes[seq], self.target_image_size)
        arr = img.astype(np.float32) / 255.0
        if jitter is not None:
            arr = apply_color_jitter(arr, jitter)
        arr = arr - 0.5
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr

    def _load_depth(self, seq: str, i: int) -> np.ndarray:
        """Inverse-depth GT (H, W, 1), 0 = invalid."""
        depth_dir = self.root / "sequences" / seq / self.depth_folder
        box = self._crop_boxes[seq]
        size = self.target_image_size
        result = np.zeros(size, dtype=np.float32)
        if self.lidar_depth and self.annotated_lidar:
            arr = read_png(depth_dir / f"{i:06d}.png").astype(np.float64)
            rows, cols = np.nonzero(arr)
            result = scatter_sparse_depth(rows, cols, 256.0 / arr[rows, cols], arr.shape, box,
                                          size)
        elif self.lidar_depth:
            from scipy import sparse

            dense = np.asarray(sparse.load_npz(depth_dir / f"{i:06d}.npz").todense())
            with np.errstate(divide="ignore"):
                inv = np.where(dense > 0, 1.0 / dense, 0.0)
            result = _nearest_crop(inv, box, size).astype(np.float32)
        elif not self.dso_depth:
            dense = _nearest_crop(np.load(depth_dir / f"{i:06d}.npy"), box, size)
            with np.errstate(divide="ignore"):
                result = np.where(dense > 0, 1.0 / dense, 0.0).astype(np.float32)

        if self.dso_depth:
            oh, ow = self._orig_sizes[seq]
            fx = self._calibs[seq]["P2" if self.use_color else "P0"][0, 0]
            arr = read_png(depth_dir / f"{i:06d}.png").astype(np.float64)
            rows, cols = np.nonzero(arr)
            rows_s = np.clip(rows / arr.shape[0] * oh, 0, oh - 1)
            cols_s = np.clip(cols / arr.shape[1] * ow, 0, ow - 1)
            vals = ow * arr[rows, cols] / (0.54 * fx * 65535.0)
            dso = scatter_sparse_depth(rows_s, cols_s, vals, (oh, ow), box, size)
            # DSO samples override; the other modality fills the holes.
            result = np.where(dso != 0, dso, result)
        return result[..., None].astype(np.float32)

    def _center(self, index: int) -> Tuple[str, int]:
        """(sequence, keyframe number) of sample ``index``."""
        s, local = self._locate(index)
        center = self._indices[s][local] if self._indices is not None else local + self._offset
        return self.sequences[s], center

    def sample_poses(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Sample ``index``'s ``keyframe_pose`` (4, 4) and source ``poses``
        (F, 4, 4), float32, exactly as ``__getitem__`` gives them; reads no
        image."""
        seq, center = self._center(index)
        poses = self._poses[seq]
        return (poses[center].astype(np.float32),
                np.stack([poses[center + i + self.offset_d] for i in self._rel]).astype(np.float32))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        seq, center = self._center(index)
        jitter = None
        if self.use_color_augmentation:
            with self._rng_lock:
                jitter = sample_color_jitter(self._rng)

        keyframe = self._load_image(self._image_path(seq, center), seq, jitter)
        poses = self._poses[seq]
        k = self._intrinsics[seq]
        frames = np.stack([
            self._load_image(self._image_path(seq, center + i + self.offset_d), seq, jitter)
            for i in self._rel])
        keyframe_pose, frame_poses = self.sample_poses(index)
        sample: Dict[str, np.ndarray] = {
            "keyframe": keyframe.astype(np.float32),
            "keyframe_pose": keyframe_pose,
            "keyframe_intrinsics": k,
            "frames": frames.astype(np.float32),
            "poses": frame_poses,
            "intrinsics": np.tile(k[None], (len(self._rel), 1, 1)),
            "sequence": np.asarray([int(seq)], dtype=np.int32),
            "image_id": np.asarray([center], dtype=np.int32),
            "target": self._load_depth(seq, center),
        }
        if self.return_stereo:
            st = np.eye(4, dtype=np.float32)
            st[0, 3] = self._baselines[seq]
            sample["stereoframe"] = self._load_image(
                self._image_path(seq, center, stereo=True), seq, jitter).astype(np.float32)
            sample["stereoframe_pose"] = (poses[center] @ st).astype(np.float32)
            sample["stereoframe_intrinsics"] = k
        if self.return_mvobj_mask > 0:
            mask = np.load(self.root / "sequences" / seq / "mvobj_mask" / f"{center:06d}.npy")
            sample["mvobj_mask"] = mask.astype(np.float32)[..., None]
            if self.return_mvobj_mask == 2:
                sample["target"] = sample["mvobj_mask"]
        return sample
