"""An OpenEXR scanline reader in numpy and zlib, for TUM mono VO's depth
(``images_depth/<frame>_d.exr``), which the JAX reader reads with
``cv2.imread(path, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``. It returns what
that call returns where cv2 is built with OpenEXR: float32, (H, W) for a
file of one channel ``Y`` and (H, W, 3) in cv2's B, G, R order for one of
``R``, ``G`` and ``B``, H and W those of the data window.

The file is the magic ``76 2f 31 01``, the version field (2, with flags for
tiled, long-name, deep and multi-part files), the header's attributes
(name, type name, size, value; an empty name ends them), of which it reads
``channels`` (a chlist: name, pixel type, pLinear, x and y sampling per
channel, in sorted order), ``compression`` and ``dataWindow`` and skips
the rest, ``lineOrder`` too: the offset table (one uint64 per chunk)
lists the chunks by increasing y whatever order the file stores them in.
Each chunk is int32 y, int32 size, data; the data runs line by line and,
in each line, channel by channel in the chlist's order, little-endian.

Compressions:

* NONE, RLE and ZIPS hold one line a chunk, ZIP sixteen;
* ZIP and ZIPS inflate with zlib, RLE undoes OpenEXR's runs (a negative
  count -n: n literal bytes; a count n >= 0: the next byte n + 1 times);
  both then undo OpenEXR's byte predictor (each byte the previous plus it
  minus 128, modulo 256) and its split of the bytes into the even and the
  odd positions;
* a chunk whose size is the raw size is stored raw (the writer keeps the
  raw bytes where compression does not shrink them).

Pixel types HALF (through ``np.float16``) and FLOAT. Tiled, multi-part and
deep files, UINT channels, subsampled channels, the PIZ, PXR24, B44, B44A,
DWAA and DWAB compressions, and channel sets other than ``Y`` or ``R, G,
B`` raise ``ValueError`` naming what is not supported.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"
COMPRESSIONS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB")
LINES_PER_CHUNK = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16}
PIXEL_TYPES = {1: np.dtype("<f2"), 2: np.dtype("<f4")}  # 0 is UINT
_TILED, _DEEP, _MULTIPART = 0x200, 0x800, 0x1000


def _cstring(data: bytes, pos: int, path) -> Tuple[str, int]:
    end = data.find(b"\x00", pos)
    if end < 0:
        raise ValueError(f"{path}: truncated EXR header")
    return data[pos:end].decode("latin-1"), end + 1


def _channels(value: bytes, path) -> List[Tuple[str, int]]:
    """(name, pixel type) of each channel of a chlist, in its order."""
    out, pos = [], 0
    while pos < len(value) and value[pos] != 0:
        name, pos = _cstring(value, pos, path)
        ptype, _, xs, ys = struct.unpack("<iB3xii", value[pos : pos + 16])
        pos += 16
        if ptype == 0:
            raise ValueError(f"{path}: channel {name} is UINT, which is not supported "
                             "(only HALF and FLOAT)")
        if ptype not in PIXEL_TYPES:
            raise ValueError(f"{path}: channel {name} has pixel type {ptype}")
        if (xs, ys) != (1, 1):
            raise ValueError(f"{path}: channel {name} is subsampled ({xs}x{ys}), which is "
                             "not supported")
        out.append((name, ptype))
    return out


def _header(data: bytes, path) -> Tuple[Dict, int]:
    """The attributes the reader needs, and the position after the header."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file (no magic number)")
    (version,) = struct.unpack("<I", data[4:8])
    if version & 0xFF != 2:
        raise ValueError(f"{path}: OpenEXR version {version & 0xFF} is not supported (only 2)")
    for flag, what in ((_MULTIPART, "multi-part"), (_DEEP, "deep"), (_TILED, "tiled")):
        if version & flag:
            raise ValueError(f"{path}: {what} OpenEXR is not supported (only single-part "
                             "scanline images)")
    attrs, pos = {}, 8
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: truncated EXR header")
        if data[pos] == 0:
            pos += 1
            break
        name, pos = _cstring(data, pos, path)
        _, pos = _cstring(data, pos, path)
        (size,) = struct.unpack("<i", data[pos : pos + 4])
        value = data[pos + 4 : pos + 4 + size]
        pos += 4 + size
        if name == "channels":
            attrs["channels"] = _channels(value, path)
        elif name == "compression":
            attrs["compression"] = value[0]
        elif name == "dataWindow":
            attrs["dataWindow"] = struct.unpack("<iiii", value)
        elif name == "tiles":
            raise ValueError(f"{path}: tiled OpenEXR is not supported (only scanline images)")
    for key in ("channels", "compression", "dataWindow"):
        if key not in attrs:
            raise ValueError(f"{path}: the EXR header has no {key} attribute")
    return attrs, pos


def rle_uncompress(src: bytes, size: int, path="") -> bytes:
    """OpenEXR's ``rleUncompress``: a signed count byte -n is followed by n
    literal bytes, a count n >= 0 by one byte repeated n + 1 times."""
    out, pos = bytearray(), 0
    while pos < len(src):
        count = src[pos] - 256 if src[pos] > 127 else src[pos]
        if count < 0:
            out += src[pos + 1 : pos + 1 - count]
            pos += 1 - count
        else:
            out += src[pos + 1 : pos + 2] * (count + 1)
            pos += 2
    if len(out) != size:
        raise ValueError(f"{path}: an RLE chunk holds {len(out)} bytes, not {size}")
    return bytes(out)


def unpredict(buf: bytes) -> bytes:
    """OpenEXR's ZIP and RLE post-processing undone: the byte predictor
    (each byte is the previous plus it minus 128), then the interleave (the
    first half of the bytes go to the even positions, the rest to the
    odd)."""
    t = np.frombuffer(buf, np.uint8).astype(np.int64)
    if t.size == 0:
        return b""
    t[1:] -= 128
    t = (np.cumsum(t) & 0xFF).astype(np.uint8)
    out = np.empty_like(t)
    half = (t.size + 1) // 2
    out[0::2], out[1::2] = t[:half], t[half:]
    return out.tobytes()


def read_exr(path) -> np.ndarray:
    """The EXR image at ``path`` as cv2 reads it: float32, (H, W) for ``Y``,
    (H, W, 3) B, G, R for ``R, G, B``."""
    data = Path(path).read_bytes()
    attrs, pos = _header(data, path)
    comp = attrs["compression"]
    name = COMPRESSIONS[comp] if comp < len(COMPRESSIONS) else str(comp)
    if name not in LINES_PER_CHUNK:
        raise ValueError(f"{path}: {name} compression is not supported "
                         f"(only {', '.join(LINES_PER_CHUNK)})")
    channels = attrs["channels"]
    names = [c for c, _ in channels]
    if names not in (["Y"], ["B", "G", "R"]):
        raise ValueError(f"{path}: channels {names} are not supported (only Y, or R, G and B)")
    x0, y0, x1, y1 = attrs["dataWindow"]
    width, height = x1 - x0 + 1, y1 - y0 + 1
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: empty data window {attrs['dataWindow']}")
    per = LINES_PER_CHUNK[name]
    n_chunks = -(-height // per)
    if pos + 8 * n_chunks > len(data):
        raise ValueError(f"{path}: truncated EXR (it ends inside its offset table)")
    offsets = struct.unpack(f"<{n_chunks}Q", data[pos : pos + 8 * n_chunks])
    # A line: the channels in the chlist's order, each width samples.
    types = [PIXEL_TYPES[t] for _, t in channels]
    line = np.dtype([(c, (t, (width,))) for c, t in zip(names, types)])
    out = {c: np.empty((height, width), np.float32) for c in names}
    for i, offset in enumerate(offsets):
        if not 0 < offset <= len(data) - 8:
            raise ValueError(f"{path}: truncated or corrupt EXR (chunk {i}'s offset {offset} "
                             "is outside the file)")
        y, size = struct.unpack("<ii", data[offset : offset + 8])
        lines = min(per, height - i * per)
        if y != y0 + i * per:
            raise ValueError(f"{path}: chunk {i} starts at line {y}, not {y0 + i * per}")
        raw_size = lines * line.itemsize
        chunk = data[offset + 8 : offset + 8 + size]
        if len(chunk) != size:
            raise ValueError(f"{path}: chunk {i} is truncated")
        if size < raw_size and name in ("ZIP", "ZIPS"):
            chunk = unpredict(zlib.decompress(chunk))
        elif size < raw_size and name == "RLE":
            chunk = unpredict(rle_uncompress(chunk, raw_size, path))
        if len(chunk) != raw_size:
            raise ValueError(f"{path}: chunk {i} holds {len(chunk)} bytes, not {raw_size}")
        rows = np.frombuffer(chunk, line)
        for c in names:
            out[c][i * per : i * per + lines] = rows[c]
    if names == ["Y"]:
        return out["Y"]
    return np.stack([out["B"], out["G"], out["R"]], axis=-1)
