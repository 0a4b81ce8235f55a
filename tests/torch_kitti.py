"""KITTI-layout trees for the port's reader, evaluation and export tests,
written with PIL at a small native size with KITTI's wide aspect (60x200,
read at 32x64). The scene is ``chip_smoke.write_kitti_tree``'s textured
plane seen by a camera moving forward; this adds what the shipped training
configs read besides: stereo images, DSO depth PNGs (``image_depth_sparse``),
dense LiDAR maps as ``.npz`` (``image_depth_npz``) and ``.npy``
(``image_depth_npy``), moving-object masks and an index-mask JSON. Not a test
module."""

import json
from pathlib import Path

import numpy as np
from PIL import Image

import chip_smoke

SIZE = (60, 200)
TARGET = (32, 64)
SEQUENCES = ("01", "07")


def pil_write(path, array):
    Image.fromarray(np.ascontiguousarray(array)).save(path)


def write_tree(root, n_frames: int = 16, sequences=SEQUENCES, seed: int = 0) -> Path:
    from scipy import sparse

    root = Path(root)
    rng = np.random.default_rng(seed)
    for s, seq in enumerate(sequences):
        depths = chip_smoke.write_kitti_tree(root, SIZE, n_frames, seq, write=pil_write,
                                             stereo=True, seed=seed + s)
        seq_dir = root / "sequences" / seq
        for sub in ("image_depth_sparse", "image_depth_npz", "image_depth_npy", "mvobj_mask"):
            (seq_dir / sub).mkdir(exist_ok=True)
        index = {}
        for i, depth in enumerate(depths):
            dso = np.where(rng.random(SIZE) < 0.03, rng.integers(1, 65535, SIZE), 0)
            pil_write(seq_dir / "image_depth_sparse" / f"{i:06d}.png", dso.astype(np.uint16))
            lidar = np.where(rng.random(SIZE) < 0.1, depth, 0.0)
            sparse.save_npz(seq_dir / "image_depth_npz" / f"{i:06d}.npz", sparse.csr_matrix(lidar))
            np.save(seq_dir / "image_depth_npy" / f"{i:06d}.npy", lidar.astype(np.float32))
            np.save(seq_dir / "mvobj_mask" / f"{i:06d}.npy",
                    (rng.random(TARGET) < 0.2).astype(np.uint8))
            index[str(i)] = bool(rng.random() < 0.7)
        (seq_dir / "mvobj_index_mask.json").write_text(json.dumps(index))
    return root
