"""A baseline greyscale JPEG decoder in Python and numpy, for the TUM mono VO
reader (the JAX package decodes its images with PIL, which the port does
not use). It gives ``np.asarray(PIL.Image.open(path))`` byte for byte where
PIL links libjpeg-turbo, whose integer IDCT and range limit it ports.

It reads what TUM mono VO ships: one 8-bit component, Huffman-coded,
sequential (SOF0 baseline or SOF1 extended), with any of the segments such
a file may hold: quantization tables of 8 or 16 bits (DQT), Huffman tables
(DHT), a restart interval (DRI) with its RSTn markers, and APPn and COM
segments, which are skipped. Colour (more than one component), progressive,
lossless, hierarchical and arithmetic-coded files and 12-bit samples raise
``ValueError`` naming what is not supported.

The decode runs in three steps:

* the entropy-coded data is split at its RSTn markers (each interval starts
  on a byte boundary with the DC predictor at 0) and unstuffed (``FF 00``
  -> ``FF``); past its end it reads zeros, as libjpeg does;
* Huffman decoding reads 16 bits ahead through a table per Huffman table
  (65536 entries, built in numpy), which gives the code's length, the
  zero run and, where code and magnitude bits fit in those 16 bits, the
  sign-extended value at once; a longer magnitude is read in a second step.
  Only this step is a Python loop, over the coded coefficients;
* ``jidctint.c::jpeg_idct_islow`` over all blocks at once in int64 numpy
  (dequantize, columns into a workspace scaled by 2^PASS1_BITS, then rows),
  with its constants and ``DESCALE`` rounding, then
  ``jdmaster.c::prepare_range_limit_table``'s post-IDCT table, indexed by
  the value ``& 1023`` (it wraps far out of range, it does not saturate),
  and the partial blocks at the right and bottom edges cropped.

PIL's libjpeg-turbo runs the same IDCT in SIMD code, whose 16-bit lanes
saturate where the C code's int arithmetic and wrapping table do not. The
two agree wherever the IDCT's values stay inside [-512, 511] and 16 bits,
which holds for every file an encoder writes from 8-bit samples; on
coefficients crafted far outside that range PIL's output differs from the
C code's, and this decoder follows the C code.
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# The zig-zag order: the natural (row-major) index of the k-th coefficient,
# with libjpeg's 16 guard entries for a corrupt run past 63.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16)

_SOF_UNSUPPORTED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic-coded (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}

# jidctint.c, 8-bit samples.
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
RANGE_MASK = 4 * 255 + 3


def _range_limit_table() -> np.ndarray:
    """The post-IDCT part of ``prepare_range_limit_table`` (8-bit): x + 128
    clamped to [0, 255] for x in [-512, 511], indexed by x & RANGE_MASK."""
    i = np.arange(RANGE_MASK + 1)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _segments(data: bytes, path):
    """(marker, payload) of each marker segment from SOI up to SOS, whose
    payload runs to the end of the data (the entropy-coded scan)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes before a marker
            pos += 1
        if pos + 3 > len(data):
            break
        marker = data[pos]
        (length,) = struct.unpack(">H", data[pos + 1 : pos + 3])
        if pos + 1 + length > len(data):
            break
        body = data[pos + 3 : pos + 1 + length]
        if marker == 0xDA:
            yield marker, body, pos + 1 + length
            return
        yield marker, body, None
        pos += 1 + length
    raise ValueError(f"{path}: truncated JPEG (it ends before its scan)")


def _frame_header(marker: int, body: bytes, path) -> Tuple[int, int, int]:
    """(width, height, quantization table) of an SOF0/SOF1 segment."""
    if marker in _SOF_UNSUPPORTED:
        raise ValueError(f"{path}: {_SOF_UNSUPPORTED[marker]} JPEG is not supported "
                         "(only baseline and extended sequential Huffman)")
    precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit samples are not supported (only 8)")
    if ncomp != 1:
        raise ValueError(f"{path}: {ncomp} components: colour JPEG is not supported "
                         "(only greyscale)")
    if height == 0:
        raise ValueError(f"{path}: the height is given by a DNL marker, which is not supported")
    return width, height, body[8]


def jpeg_size(path) -> Tuple[int, int]:
    """(width, height) from the frame header, without decoding the image
    (the order of ``PIL.Image.size``)."""
    data = Path(path).read_bytes()
    for marker, body, _ in _segments(data, path):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return _frame_header(marker, body, path)[:2]
    raise ValueError(f"{path}: no frame header")


def _quant_tables(body: bytes, tables: Dict[int, np.ndarray]) -> None:
    pos = 0
    while pos < len(body):
        precision, index = body[pos] >> 4, body[pos] & 15
        if precision:
            vals = np.frombuffer(body[pos + 1 : pos + 129], ">u2").astype(np.int64)
            pos += 129
        else:
            vals = np.frombuffer(body[pos + 1 : pos + 65], np.uint8).astype(np.int64)
            pos += 65
        table = np.zeros(64, np.int64)
        table[ZIGZAG[:64]] = vals  # stored in zig-zag order
        tables[index] = table.reshape(8, 8)


@functools.lru_cache(maxsize=16)
def _lookahead(counts: bytes, symbols: bytes, is_dc: bool) -> List:
    """The 16-bit lookahead table of one Huffman table: for each 16-bit
    window, (bits consumed, zero run, value, magnitude bits still to read),
    or None where no code matches. The run is -1 for an end of block; the
    value is complete (its magnitude bits inside the window) when the last
    field is 0. Cached: the files of a sequence share their tables."""
    lengths = np.zeros(1 << 16, np.int64)
    syms = np.full(1 << 16, -1, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            if hi > 1 << 16:
                raise ValueError("invalid Huffman table (code past 16 bits)")
            lengths[lo:hi] = length
            syms[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    window = np.arange(1 << 16)
    if is_dc:
        # A DC magnitude category past 15 cannot be read: no code there.
        syms = np.where(syms > 15, -1, syms)
        run, size = np.zeros_like(syms), np.maximum(syms, 0)
    else:
        run, size = syms >> 4, syms & 15
        run = np.where((size == 0) & (run != 15), -1, run)  # EOB (and r < 15, s = 0)
    fits = lengths + size <= 16
    shift = np.where(fits, 16 - lengths - size, 0)
    bits = (window >> shift) & ((1 << size) - 1)
    value = np.where(bits < (1 << np.maximum(size - 1, 0)), bits - (1 << size) + 1, bits)
    value = np.where(size == 0, 0, value)
    consumed = np.where(fits, lengths + size, lengths)
    pending = np.where(fits, 0, size)
    return [None if s < 0 else (c, r, v, p) for s, c, r, v, p in zip(
        syms.tolist(), consumed.tolist(), run.tolist(), value.tolist(), pending.tolist())]


def _entropy_intervals(data: bytes, start: int, path) -> List[bytes]:
    """The scan's entropy-coded data from ``start``, split at its RSTn
    markers and unstuffed, up to the next other marker."""
    intervals, begin, pos = [], start, start
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            intervals.append(data[begin:])  # no EOI: read what there is
            break
        nxt = data[pos + 1]
        if nxt == 0x00:
            pos += 2
            continue
        end = pos
        while nxt == 0xFF and pos + 2 < len(data):  # fill bytes before a marker
            pos += 1
            nxt = data[pos + 1]
        intervals.append(data[begin:end])
        if not 0xD0 <= nxt <= 0xD7:
            break
        begin = pos = pos + 2
    return [seg.replace(b"\xff\x00", b"\xff") for seg in intervals]


def _decode_coefficients(intervals: List[bytes], n_blocks: int, restart: int, dc_table,
                         ac_table, path) -> np.ndarray:
    """The quantized coefficients (n_blocks, 64), natural order, int16."""
    per = restart if restart else n_blocks
    if len(intervals) < -(-n_blocks // per):
        raise ValueError(f"{path}: {len(intervals)} restart intervals for {n_blocks} blocks "
                         f"of {per}")
    coef = [0] * (n_blocks * 64)
    zz = ZIGZAG.tolist()
    for i in range(-(-n_blocks // per)):
        # Zeros past the end: a block that runs off the data reads them, as
        # in libjpeg, and the next block's start raises.
        seg = np.frombuffer(intervals[i] + b"\x00" * 256, np.uint8).astype(np.int64)
        # A 32-bit big-endian window at every byte offset.
        win = ((seg[:-3] << 24) | (seg[1:-2] << 16) | (seg[2:-1] << 8) | seg[3:]).tolist()
        limit = len(intervals[i]) * 8
        pos = pred = 0
        for blk in range(i * per, min((i + 1) * per, n_blocks)):
            base = blk * 64
            if pos > limit:
                raise ValueError(f"{path}: the entropy-coded data ends inside block {blk}")
            entry = dc_table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if entry is None:
                raise ValueError(f"{path}: corrupt DC code in block {blk}")
            n, _, v, s = entry
            pos += n
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pos += s
            pred += v
            coef[base] = pred
            k = 1
            while k < 64:
                entry = ac_table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if entry is None:
                    raise ValueError(f"{path}: corrupt AC code in block {blk}")
                n, r, v, s = entry
                pos += n
                if r < 0:
                    break
                if s:
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    pos += s
                k += r
                coef[base + zz[k]] = v
                k += 1
    # JCOEF is 16 bits: a DC sum out of range wraps, as it does in libjpeg.
    return np.asarray(coef, np.int64).astype(np.int16).reshape(n_blocks, 64)


def _idct_pass(v, out_shift: int):
    """One 1-D pass of ``jpeg_idct_islow`` over the 8 inputs ``v`` (arrays),
    its outputs DESCALEd by ``out_shift`` bits."""
    z1 = (v[2] + v[6]) * FIX_0_541196100
    tmp2 = z1 + v[6] * -FIX_1_847759065
    tmp3 = z1 + v[2] * FIX_0_765366865
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4

    half = 1 << (out_shift - 1)
    return [(x + half) >> out_shift for x in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` of (N, 8, 8) natural-order coefficients with an
    (8, 8) quantization table: (N, 8, 8) uint8 samples."""
    x = coef.astype(np.int64) * quant
    # Pass 1: the columns (the 8 rows of each column are its inputs), into
    # the int workspace.
    ws = _idct_pass([x[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
    ws = np.stack(ws, axis=1).astype(np.int32).astype(np.int64)
    # Pass 2: the rows, descaled by 8 and 2^PASS1_BITS.
    out = _idct_pass([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3)
    return _RANGE_LIMIT[np.stack(out, axis=2) & RANGE_MASK]


def read_jpeg(path) -> np.ndarray:
    """The greyscale image at ``path`` as (H, W) uint8."""
    data = Path(path).read_bytes()
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List] = {}
    frame, restart = None, 0
    for marker, body, scan_start in _segments(data, path):
        if marker == 0xDB:
            _quant_tables(body, quant)
        elif marker == 0xC4:
            pos = 0
            while pos < len(body):
                kind, index = body[pos] >> 4, body[pos] & 15
                counts = body[pos + 1 : pos + 17]
                n = sum(counts)
                huff[kind, index] = _lookahead(counts, body[pos + 17 : pos + 17 + n], kind == 0)
                pos += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG (DAC) is not supported")
        elif 0xC0 <= marker <= 0xCF and marker != 0xC8:
            frame = _frame_header(marker, body, path)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            ss, se, a = body[-3], body[-2], body[-1]
            if body[0] != 1 or (ss, se, a) != (0, 63, 0):
                raise ValueError(f"{path}: a partial scan is not supported (baseline only)")
            tables = body[2]
            width, height, qi = frame
            if qi not in quant or (0, tables >> 4) not in huff or (1, tables & 15) not in huff:
                raise ValueError(f"{path}: a table the scan names is not defined")
            bw, bh = -(-width // 8), -(-height // 8)
            coef = _decode_coefficients(_entropy_intervals(data, scan_start, path), bw * bh,
                                        restart, huff[0, tables >> 4], huff[1, tables & 15],
                                        path)
            blocks = idct_islow(coef.reshape(-1, 8, 8), quant[qi])
            image = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
            return np.ascontiguousarray(image[:height, :width])
        elif marker in (0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
            raise ValueError(f"{path}: unexpected marker 0x{marker:02X} before the scan")
        # APPn, COM and any other segment: skipped.
    raise ValueError(f"{path}: no scan")
