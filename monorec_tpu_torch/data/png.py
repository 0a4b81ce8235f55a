"""A PNG reader in zlib and numpy, for the images and depth maps of the KITTI
reader (the JAX package decodes them with PIL, which the port does not use),
and ``write_png``, a writer of 8-bit greyscale and RGB images for the
inference example's outputs.

It reads what KITTI ships: greyscale (colour type 0) and RGB (colour type 2)
images of 8 or 16 bits per sample, not interlaced, with any of the five row
filters and the image data split over any number of IDAT chunks. 16-bit
samples (big-endian in the file) come back as native ``uint16``; 8-bit ones
as ``uint8``. Greyscale images are (H, W), RGB images (H, W, 3): the arrays
``np.asarray(PIL.Image.open(path))`` gives for 8-bit greyscale, 8-bit RGB and
16-bit greyscale (PIL reduces 16-bit RGB to 8 bits; this reader keeps all
16). Palette images, alpha channels, bit depths below 8 and interlaced
images raise ``ValueError`` naming what is not supported, as does a chunk
whose CRC does not match.

The None, Sub and Up filters are undone with numpy over a whole row; Average
and Paeth depend on the pixel to their left, so they run as a loop over the
row's bytes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}
_UNSUPPORTED_COLOUR = {3: "palette (colour type 3)", 4: "greyscale with alpha (colour type 4)",
                       6: "RGB with alpha (colour type 6)"}


def _check_signature(head: bytes, path) -> None:
    if head[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")


def png_size(path) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk, without decoding the image
    (the order of ``PIL.Image.size``)."""
    with open(path, "rb") as f:
        head = f.read(24)
    _check_signature(head, path)
    if head[12:16] != b"IHDR":
        raise ValueError(f"{path}: the first chunk is not IHDR")
    return struct.unpack(">II", head[16:24])


def _chunks(data: bytes, path):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind.decode('latin-1')!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_average(cur: list, up: list, bpp: int) -> None:
    for i in range(bpp):
        cur[i] = (cur[i] + (up[i] >> 1)) & 255
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 255


def _unfilter_paeth(cur: list, up: list, bpp: int) -> None:
    for i in range(bpp):  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + up[i]) & 255
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 255


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of (H, 1 + stride) uint8 scanlines (the filter
    type first); returns the (H, stride) bytes."""
    out = rows[:, 1:].copy()
    prior = np.zeros(out.shape[1], np.uint8)
    for r, kind in enumerate(rows[:, 0].tolist()):
        line = out[r]
        if kind == 1:
            line[:] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            line += prior
        elif kind in (3, 4):
            cur = line.tolist()
            (_unfilter_average if kind == 3 else _unfilter_paeth)(cur, prior.tolist(), bpp)
            line[:] = cur
        elif kind != 0:
            raise ValueError(f"unknown PNG row filter {kind} in row {r}")
        prior = line
    return out


def read_png(path) -> np.ndarray:
    """The image at ``path`` as (H, W) or (H, W, 3), ``uint8`` or ``uint16``."""
    data = Path(path).read_bytes()
    _check_signature(data, path)
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind not in (b"IEND", b"PLTE") and kind[0:1].isupper():
            raise ValueError(f"{path}: unsupported critical chunk {kind.decode('latin-1')!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filter_method, interlace = header
    if colour in _UNSUPPORTED_COLOUR:
        raise ValueError(f"{path}: {_UNSUPPORTED_COLOUR[colour]} is not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {colour}")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported (only 8 and 16)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown compression or filter method")
    channels, nbytes = _CHANNELS[colour], depth // 8
    bpp = channels * nbytes
    raw = zlib.decompress(b"".join(idat))
    size = height * (1 + width * bpp)
    if len(raw) < size:
        raise ValueError(f"{path}: image data is {len(raw)} bytes, expected {size}")
    rows = np.frombuffer(raw, np.uint8, size).reshape(height, 1 + width * bpp)
    pixels = unfilter(rows, bpp)
    if nbytes == 2:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


def write_png(path, array) -> None:
    """Write a ``uint8`` (H, W) greyscale or (H, W, 3) RGB array as a PNG:
    every row unfiltered (filter 0), the image data in one IDAT chunk."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    colour = 0 if a.ndim == 2 else 2
    scan = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    Path(path).write_bytes(
        SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(scan.tobytes(), 6)) + chunk(b"IEND", b""))
