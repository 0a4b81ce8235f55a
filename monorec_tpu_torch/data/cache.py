"""Memory-mapped sample cache (``monorec_tpu/data/cache.py``), in the JAX
package's on-disk format, so a cache built by either package reads in the
other.

``build_cache`` runs a dataset once and stores each sample key as the rows of
a flat memory-mapped ``<key>.npy`` (``meta.json`` lists the keys, their
shapes and dtypes, and which keys are images). Image keys are stored as
uint8, (v + 0.5) * 255 rounded: the sources are 8-bit PNGs, so the only loss
is the sub-LSB rounding of the bilinear resize. ``CachedDataset`` serves a
sample with a copy and a uint8 -> float conversion, and draws the colour
jitter anew for every sample it serves, so augmentation stays random across
epochs (a cache of jittered images would freeze it).

    python -m monorec_tpu_torch.tools.build_cache \
        -c configs/train/monorec/monorec_depth.json --out saved/cache/kitti_train
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from monorec_tpu_torch.data.color_jitter import apply_color_jitter, sample_color_jitter

IMAGE_KEYS = ("keyframe", "frames", "stereoframe")


def build_cache(dataset, out_dir: str, image_keys: Sequence[str] = IMAGE_KEYS,
                log_every: int = 200) -> Path:
    """Write every sample of ``dataset`` into ``out_dir``, one memmap per key.

    Build it from a dataset WITHOUT colour augmentation: the cache stores
    clean images and ``CachedDataset`` jitters them."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    first = dataset[0]
    mms: Dict[str, np.memmap] = {}
    meta = {"n": n, "keys": {}, "image_keys": list(image_keys)}
    for k, v in first.items():
        v = np.asarray(v)
        dtype = "uint8" if k in image_keys else str(v.dtype)
        mms[k] = np.lib.format.open_memmap(out / f"{k}.npy", mode="w+", dtype=dtype,
                                           shape=(n,) + v.shape)
        meta["keys"][k] = {"shape": list(v.shape), "dtype": dtype}
    for i in range(n):
        s = dataset[i] if i else first
        for k, mm in mms.items():
            v = np.asarray(s[k])
            if k in image_keys:
                v = np.clip(np.round((v + 0.5) * 255.0), 0, 255).astype(np.uint8)
            mm[i] = v
        if log_every and i % log_every == 0:
            print(f"cache: {i}/{n}")
    for mm in mms.values():
        mm.flush()
    (out / "meta.json").write_text(json.dumps(meta))
    return out


class CachedDataset:
    """Samples of a ``build_cache`` directory, images as float32 in
    [-0.5, 0.5], jittered per sample when ``color_augmentation``."""

    def __init__(self, cache_dir: str, color_augmentation: bool = False, seed: int = 0,
                 custom_length: Optional[int] = None):
        self.cache_dir = Path(cache_dir)
        meta = json.loads((self.cache_dir / "meta.json").read_text())
        self.n = meta["n"] if custom_length is None else min(custom_length, meta["n"])
        self.image_keys = set(meta["image_keys"]) & set(meta["keys"])
        self._mms = {k: np.load(self.cache_dir / f"{k}.npy", mmap_mode="r") for k in meta["keys"]}
        self.use_color_augmentation = color_augmentation
        self._rng = np.random.default_rng(seed)
        # np.random.Generator is not thread-safe: serialize the draws.
        self._rng_lock = threading.Lock()

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        jitter = None
        if self.use_color_augmentation:
            with self._rng_lock:
                jitter = sample_color_jitter(self._rng)
        out: Dict[str, np.ndarray] = {}
        for k, mm in self._mms.items():
            v = np.array(mm[i])
            if k in self.image_keys:
                v = v.astype(np.float32) / 255.0
                if jitter is not None:
                    v = (np.stack([apply_color_jitter(f, jitter) for f in v]) if v.ndim == 4
                         else apply_color_jitter(v, jitter))
                v = v - 0.5
            out[k] = v
        return out
