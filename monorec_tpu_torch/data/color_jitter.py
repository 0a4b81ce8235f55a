"""Per-sample colour jitter of the host-side readers
(``monorec_tpu/data/color_jitter.py``), numpy: brightness, contrast,
saturation and hue, one draw per sample applied to every frame of it, with
the same ``np.random.Generator`` draws as the JAX package's. Float images in
[0, 1], HWC RGB.

The trainers' on-device jitter (``trainer.color_aug_on_device``) is
``models/augmentation.py::jitter_image_keys``; this one belongs to the
KITTI reader's ``use_color_augmentation`` and to ``CachedDataset``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ColorJitterParams(NamedTuple):
    brightness: float
    contrast: float
    saturation: float
    hue: float
    order: tuple


def sample_color_jitter(
    rng: np.random.Generator,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    hue: float = 0.1,
) -> ColorJitterParams:
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    order = tuple(rng.permutation(4).tolist())
    return ColorJitterParams(b, c, s, h, order)


_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _adjust_brightness(img, f):
    return np.clip(img * f, 0.0, 1.0)


def _adjust_contrast(img, f):
    mean = (img @ _LUMA).mean()
    return np.clip(mean + (img - mean) * f, 0.0, 1.0)


def _adjust_saturation(img, f):
    gray = (img @ _LUMA)[..., None]
    return np.clip(gray + (img - gray) * f, 0.0, 1.0)


def _adjust_hue(img, shift):
    """Hue rotation by `shift` (fraction of a full turn) via HSV round trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)

    safe = np.maximum(delta, 1e-12)
    h = np.where(
        maxc == r, ((g - b) / safe) % 6.0,
        np.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = np.where(delta == 0, 0.0, h) / 6.0
    h = (h + shift) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6

    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-1)


def apply_color_jitter(img: np.ndarray, p: ColorJitterParams) -> np.ndarray:
    if img.ndim == 2:  # grayscale: hue/saturation are no-ops
        img3 = np.stack([img] * 3, axis=-1)
    else:
        img3 = img
    ops = [
        lambda x: _adjust_brightness(x, p.brightness),
        lambda x: _adjust_contrast(x, p.contrast),
        lambda x: _adjust_saturation(x, p.saturation),
        lambda x: _adjust_hue(x, p.hue),
    ]
    for i in p.order:
        img3 = ops[i](img3)
    if img.ndim == 2:
        return img3[..., 0]
    return img3.astype(np.float32)
