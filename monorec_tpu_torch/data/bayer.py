"""Bilinear Bayer demosaic in numpy, byte for byte what OpenCV's
``cv2.cvtColor(raw, cv2.COLOR_BayerGB2RGB)`` gives, for the RobotCar reader
(the JAX package calls cv2, which the port does not use).

OpenCV names a pattern by the second row's second and third pixels, so its
"GB" is, from the top-left corner::

    G R G R ...
    B G B G ...

red on even rows at odd columns, blue on odd rows at even columns, green
where row and column have the same parity. Each interior pixel keeps its own
sample and takes the other two colours as the mean of their nearest samples:
the 4-neighbour cross (green at a red or blue pixel), the 4 diagonals (blue
at red, red at blue), or the 2 horizontal or 2 vertical neighbours (red and
blue at green), rounded half up in integers. The border rows and columns are
copies of their inner neighbours: row 0 of row 1, the last row of the one
before it, column 0 of column 1, the last column of the one before it.
"""

from __future__ import annotations

import numpy as np


def demosaic_gb2rgb(raw: np.ndarray) -> np.ndarray:
    """(H, W) uint8 Bayer samples -> (H, W, 3) uint8 RGB, H and W >= 3."""
    if raw.dtype != np.uint8 or raw.ndim != 2:
        raise ValueError(f"demosaic_gb2rgb takes (H, W) uint8, not {raw.shape} {raw.dtype}")
    h, w = raw.shape
    if h < 3 or w < 3:
        raise ValueError(f"demosaic_gb2rgb needs at least 3x3 samples, not {h}x{w}")
    p = raw.astype(np.int32)
    centre = p[1:-1, 1:-1]
    left, right, up, down = p[1:-1, :-2], p[1:-1, 2:], p[:-2, 1:-1], p[2:, 1:-1]
    horizontal = (left + right + 1) >> 1
    vertical = (up + down + 1) >> 1
    cross = (left + right + up + down + 2) >> 2
    diagonal = (p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:] + 2) >> 2
    odd_row = (np.arange(1, h - 1) % 2 == 1)[:, None]
    odd_col = (np.arange(1, w - 1) % 2 == 1)[None, :]
    red = ~odd_row & odd_col
    blue = odd_row & ~odd_col
    green = odd_row == odd_col
    r = np.where(red, centre, np.where(blue, diagonal, np.where(odd_row, vertical, horizontal)))
    g = np.where(green, centre, cross)
    b = np.where(blue, centre, np.where(red, diagonal, np.where(odd_row, horizontal, vertical)))
    out = np.empty((h, w, 3), np.uint8)
    out[1:-1, 1:-1] = np.stack([r, g, b], axis=-1)
    out[0], out[-1] = out[1], out[-2]
    out[:, 0], out[:, -1] = out[:, 1], out[:, -2]
    return out
