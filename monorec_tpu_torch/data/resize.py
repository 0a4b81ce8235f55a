"""Crop and bilinear resize in numpy, bit for bit what Pillow gives:
``PIL.Image.crop(box).resize((tw, th), Image.BILINEAR)`` of 8-bit images
(``crop_resize_bilinear``) and ``Image.fromarray(float32 2-D).resize((tw,
th), Image.BILINEAR)`` of float images (``resize_bilinear_float``).

It is the algorithm of Pillow's ``Resample.c`` (``ImagingResample`` with
the triangle filter), which the KITTI and TUM readers of the JAX package
call:

* ``precompute_coeffs``: for each output pixel, the source span and the
  triangle weights, the filter widened by the downscale factor (so a
  downscale averages, it does not alias), normalized to sum to 1;
* 8 bits per channel: ``normalize_coeffs_8bpc``, the weights in fixed
  point with 22 fraction bits, rounded half away from zero; a horizontal
  pass, rounded (+ half) and clipped to uint8, then the vertical pass the
  same way;
* 32-bit float (mode F): the weights as they are, in float64; each pass
  sums its taps in float64, in order, and stores float32;
* either way a size that does not change is copied. Pillow runs the
  horizontal pass only over the rows the vertical pass reads; the rows are
  independent, so running it over all of them gives the same result.

The weights are computed in float64 in Pillow's order of operations, and
the 8-bit arithmetic is integer after them, so the result is exact.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``precompute_coeffs``: the first source index and the span of each
    output pixel (out_size,) and its normalized float64 weights (out_size,
    ksize), zero past the span."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support, 1, widened on a downscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    w = np.maximum(1.0 - np.abs(((taps + xmin[:, None]) - center[:, None] + 0.5) * ss), 0.0)
    w = np.where(taps < xmax[:, None], w, 0.0)
    ww = w[:, 0].copy()
    for j in range(1, ksize):  # Pillow's order of summation
        ww += w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    return xmin, xmax, w


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The first source index of each output pixel (out_size,) and its
    fixed-point weights (out_size, ksize), zero past the span."""
    xmin, _, w = _weights(in_size, out_size)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    return xmin, fixed


def _resample(src: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bpc resample along ``axis`` (0 rows, 1 columns)."""
    in_size = src.shape[axis]
    xmin, fixed = _coeffs(in_size, out_size)
    shape = [1] * src.ndim
    shape[axis] = out_size
    acc = np.int32(1 << (PRECISION_BITS - 1))
    for j in range(fixed.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)  # weight 0 where clamped
        acc = acc + np.take(src, idx, axis=axis).astype(np.int32) * fixed[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def crop_resize_bilinear(img: np.ndarray, box: Sequence[int], size: Tuple[int, int]) -> np.ndarray:
    """Crop ``img`` (H, W) or (H, W, C) uint8 to ``box`` = (left, top, right,
    bottom), inside the image, and resize it to ``size`` = (th, tw) with
    Pillow's BILINEAR."""
    if img.dtype != np.uint8:
        raise ValueError(f"crop_resize_bilinear takes uint8 images, not {img.dtype}")
    left, top, right, bottom = (int(v) for v in box)
    if not (0 <= left < right <= img.shape[1] and 0 <= top < bottom <= img.shape[0]):
        raise ValueError(f"crop box {tuple(box)} is not inside the image {img.shape[:2]}")
    out = img[top:bottom, left:right]
    th, tw = size
    ch, cw = out.shape[:2]
    if (ch, cw) == (th, tw):
        return out.copy()
    if cw != tw:
        out = _resample(out, tw, 1)
    if ch != th:
        out = _resample(out, th, 0)
    return out


def _resample_float(src: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 32-bpc float resample along ``axis``: the taps
    inside each span summed in float64 in order, stored as float32."""
    in_size = src.shape[axis]
    xmin, xmax, w = _weights(in_size, out_size)
    shape = [1] * src.ndim
    shape[axis] = out_size
    acc = np.zeros(1)
    for j in range(w.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        tap = np.take(src, idx, axis=axis).astype(np.float64) * w[:, j].reshape(shape)
        # Past the span Pillow adds nothing (an inf there would give NaN).
        acc = acc + np.where((j < xmax).reshape(shape), tap, 0.0)
    return acc.astype(np.float32)


def resize_bilinear_float(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((tw, th), Image.BILINEAR)`` of a 2-D
    float32 ``img`` (Pillow's mode F), ``size`` = (th, tw): float32."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise ValueError(f"resize_bilinear_float takes 2-D float32 images, not {img.dtype} "
                         f"{img.shape}")
    th, tw = size
    h, w = img.shape
    if (h, w) == (th, tw):
        return img.copy()
    out = img
    if w != tw:
        out = _resample_float(out, tw, 1)
    if h != th:
        out = _resample_float(out, th, 0)
    return out
