"""A baseline JPEG decoder in Python and numpy, greyscale and colour, for
the TUM mono VO reader (the JAX package decodes its images with PIL, which
the port does not use). It gives ``np.asarray(PIL.Image.open(path))`` byte
for byte where PIL links libjpeg-turbo, whose integer IDCT, chroma
upsampling, colour conversion and range limits it ports: (H, W) uint8 for
one component, (H, W, 3) RGB for three.

It reads sequential Huffman-coded files with 8-bit samples (SOF0 baseline
or SOF1 extended) of one component, or of three with horizontal and
vertical sampling factors of 1 or 2 each (4:4:4, 4:2:2, 4:2:0, 4:4:0 and
the rest), their components in one interleaved scan or each in a scan of
its own, with any of the segments such a file may hold: quantization
tables of 8 or 16 bits (DQT), Huffman tables (DHT), a restart interval
(DRI) with its RSTn markers, an Adobe APP14 segment (whose transform 0
marks a three-component file as RGB, unless a JFIF APP0 says YCbCr), and
other APPn and COM segments, which are skipped. Four components
(CMYK/YCCK), two, progressive, lossless, hierarchical and arithmetic-coded
files and 12-bit samples raise ``ValueError`` naming what is not supported.

The decode runs in these steps:

* the entropy-coded data of each scan is split at its RSTn markers (each
  interval starts on a byte boundary with every DC predictor at 0; the
  interval counts MCUs, one block in a one-component scan) and unstuffed
  (``FF 00`` -> ``FF``); past its end it reads zeros, as libjpeg does;
* Huffman decoding reads 16 bits ahead through a table per Huffman table
  (65536 entries, built in numpy), which gives the code's length, the
  zero run and, where code and magnitude bits fit in those 16 bits, the
  sign-extended value at once; a longer magnitude is read in a second step.
  Only this step is a Python loop, over the coded coefficients; each
  component keeps its own DC predictor and tables;
* ``jidctint.c::jpeg_idct_islow`` over all blocks of a component at once
  in int64 numpy (dequantize, columns into a workspace scaled by
  2^PASS1_BITS, then rows), with its constants and ``DESCALE`` rounding,
  then ``jdmaster.c::prepare_range_limit_table``'s post-IDCT table,
  indexed by the value ``& 1023`` (it wraps far out of range, it does not
  saturate), and each component cropped to its downsampled size
  (``jdmaster.c``'s ``downsampled_width`` / ``height``);
* the chroma upsampling that ``jdsample.c::jinit_upsampler`` picks with
  fancy upsampling on (PIL's default): the triangle filters
  ``h2v1_fancy_upsample`` and ``h2v2_fancy_upsample`` where the
  downsampled width is over 2, else the replicating ``h2v1_upsample`` /
  ``h2v2_upsample``, and ``h1v2_fancy_upsample``; the rows above the first
  and below the last are copies of them (``jdmainct.c``'s context rows),
  as are the columns beside the first and last;
* ``jdcolor.c::ycc_rgb_convert``: the ``build_ycc_rgb_table`` integer
  tables (16 fraction bits, rounded) and the range limit to [0, 255].

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

# jdcolor.c, build_ycc_rgb_table.
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def _range_limit_table() -> np.ndarray:
    """The post-IDCT part of ``prepare_range_limit_table`` (8-bit): x + 128
    clamped to [0, 255] for x in [-512, 511], indexed by x & RANGE_MASK."""
    i = np.arange(RANGE_MASK + 1)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


def _ycc_rgb_tables() -> Tuple[np.ndarray, ...]:
    """``build_ycc_rgb_table``: Cr -> R, Cb -> B (rounded), Cr -> G and
    Cb -> G (scaled by 2^16, ONE_HALF in the latter), indexed by 0..255."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


_RANGE_LIMIT = _range_limit_table()
_YCC_RGB = _ycc_rgb_tables()


def _next_segment(data: bytes, pos: int, path):
    """(marker, payload, position after it) of the marker at ``pos``; SOI,
    EOI and RSTn have no payload. Raises where the data ends first."""
    if pos >= len(data) or data[pos] != 0xFF:
        raise ValueError(f"{path}: no marker at byte {pos}")
    while pos < len(data) and data[pos] == 0xFF:  # fill bytes before a marker
        pos += 1
    if pos >= len(data):
        raise ValueError(f"{path}: truncated JPEG (it ends before its scan)")
    marker = data[pos]
    if marker in (0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
        return marker, b"", pos + 1
    if pos + 3 > len(data):
        raise ValueError(f"{path}: truncated JPEG (it ends before its scan)")
    (length,) = struct.unpack(">H", data[pos + 1 : pos + 3])
    if pos + 1 + length > len(data):
        raise ValueError(f"{path}: truncated JPEG (it ends before its scan)")
    return marker, data[pos + 3 : pos + 1 + length], pos + 1 + length


def _frame_header(marker: int, body: bytes, path) -> Tuple[int, int, List[Tuple[int, ...]]]:
    """(width, height, components) of an SOF0/SOF1 segment, each component
    (id, h, v, quantization table)."""
    if marker in _SOF_UNSUPPORTED:
        raise ValueError(f"{path}: {_SOF_UNSUPPORTED[marker]} JPEG is not supported "
                         "(only baseline and extended sequential Huffman)")
    precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit samples are not supported (only 8)")
    if ncomp == 4:
        raise ValueError(f"{path}: 4 components: CMYK/YCCK JPEG is not supported "
                         "(only greyscale and three-component colour)")
    if ncomp not in (1, 3):
        raise ValueError(f"{path}: {ncomp} components are not supported "
                         "(only greyscale and three-component colour)")
    if height == 0:
        raise ValueError(f"{path}: the height is given by a DNL marker, which is not supported")
    comps = []
    for c in range(ncomp):
        cid, hv, tq = body[6 + 3 * c : 9 + 3 * c]
        h, v = hv >> 4, hv & 15
        if ncomp == 1:
            h = v = 1  # a single component is never subsampled
        if not (1 <= h <= 2 and 1 <= v <= 2):
            raise ValueError(f"{path}: sampling factors {hv >> 4}x{hv & 15} are not supported "
                             "(only 1 and 2)")
        comps.append((cid, h, v, tq))
    return width, height, comps


def jpeg_size(path) -> Tuple[int, int]:
    """(width, height) from the frame header, without decoding the image
    (the order of ``PIL.Image.size``)."""
    data = Path(path).read_bytes()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        marker, body, pos = _next_segment(data, pos, path)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return _frame_header(marker, body, path)[:2]
        if marker in (0xDA, 0xD9):
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


def _entropy_intervals(data: bytes, start: int) -> Tuple[List[bytes], int]:
    """The scan's entropy-coded data from ``start``, split at its RSTn
    markers and unstuffed, and the position of the marker after it (the
    data's length where none follows)."""
    intervals, begin, pos = [], start, start
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            intervals.append(data[begin:])  # no EOI: read what there is
            end = len(data)
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
    return [seg.replace(b"\xff\x00", b"\xff") for seg in intervals], end


def _decode_coefficients(intervals: List[bytes], slots: List[int], per: int, dc_tables,
                         ac_tables, path) -> np.ndarray:
    """The quantized coefficients (n_blocks, 64), natural order, int16, of
    the blocks in coding order; block ``i`` belongs to component slot
    ``slots[i]``, whose Huffman tables and DC predictor it uses; each
    restart interval holds ``per`` blocks."""
    n_blocks = len(slots)
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
        pos = 0
        pred = [0] * len(dc_tables)
        for blk in range(i * per, min((i + 1) * per, n_blocks)):
            base = blk * 64
            slot = slots[blk]
            ac_table = ac_tables[slot]
            if pos > limit:
                raise ValueError(f"{path}: the entropy-coded data ends inside block {blk}")
            entry = dc_tables[slot][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if entry is None:
                raise ValueError(f"{path}: corrupt DC code in block {blk}")
            n, _, v, s = entry
            pos += n
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pos += s
            pred[slot] += v
            coef[base] = pred[slot]
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


def _edge(p: np.ndarray, axis: int):
    """(previous, next) neighbours of ``p`` along ``axis``, the first and
    last samples standing in for the ones beyond the edges."""
    n = p.shape[axis]
    prev = np.take(p, np.r_[0, np.arange(n - 1)], axis=axis)
    nxt = np.take(p, np.r_[np.arange(1, n), n - 1], axis=axis)
    return prev, nxt


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A downsampled component (its downsampled size) upsampled by ``fh``
    horizontally and ``fv`` vertically (1 or 2 each), as
    ``jinit_upsampler`` picks the method with fancy upsampling on."""
    p = p.astype(np.int64)
    if (fh, fv) == (1, 1):
        return p
    if fh == 2 and p.shape[1] <= 2:  # the plain upsamplers: replication
        return np.repeat(np.repeat(p, 2, axis=1), fv, axis=0)
    if (fh, fv) == (2, 1):  # h2v1_fancy_upsample
        left, right = _edge(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    above, below = _edge(p, 0)
    if fh == 1:  # h1v2_fancy_upsample
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, 0)
    # h2v2_fancy_upsample: column sums with the nearer row weighted 3, then
    # 3:1 across columns, the biases 8 and 7 alternating.
    sums = _interleave(3 * p + above, 3 * p + below, 0)
    left, right = _edge(sums, 1)
    return _interleave((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4, 1)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``ycc_rgb_convert`` of three (H, W) planes: (H, W, 3) uint8 RGB."""
    cr_r, cb_b, cr_g, cb_g = _YCC_RGB
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS), y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _scan(body: bytes, frame, grids, quant, latched, huff, restart, data, start, path) -> int:
    """Decodes one scan into the coefficient ``grids`` of its components and
    latches their quantization tables; returns the position after its
    entropy-coded data."""
    width, height, comps = frame
    ns = body[0]
    ss, se, a = body[1 + 2 * ns : 4 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        raise ValueError(f"{path}: a partial scan is not supported (baseline only)")
    ids = [c[0] for c in comps]
    members = []
    for j in range(ns):
        cs, tables = body[1 + 2 * j : 3 + 2 * j]
        if cs not in ids:
            raise ValueError(f"{path}: the scan names component {cs}, which the frame lacks")
        ci = ids.index(cs)
        if comps[ci][3] not in quant or (0, tables >> 4) not in huff or (
                1, tables & 15) not in huff:
            raise ValueError(f"{path}: a table the scan names is not defined")
        latched.setdefault(ci, quant[comps[ci][3]].copy())
        members.append((ci, tables))
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if ns == 1:
        # Non-interleaved: the blocks of the component's downsampled size.
        ci = members[0][0]
        _, h, v, _ = comps[ci]
        bw = -(-width * h // (8 * hmax))
        bh = -(-height * v // (8 * vmax))
        cols = grids[ci].shape[1]
        dest = [(np.arange(bh)[:, None] * cols + np.arange(bw)[None, :]).reshape(-1)]
        slots, per_mcu = [0] * (bw * bh), 1
    else:
        # Interleaved: MCUs of h x v blocks of each component in turn.
        mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        order, dest = [], []
        for slot, (ci, _) in enumerate(members):
            _, h, v, _ = comps[ci]
            cols = grids[ci].shape[1]
            by, bx = np.arange(v)[:, None], np.arange(h)[None, :]
            mcu_y, mcu_x = np.meshgrid(np.arange(my), np.arange(mx), indexing="ij")
            # (MCU, block within the MCU) -> the block's index in the grid.
            idx = ((mcu_y.reshape(-1, 1, 1) * v + by) * cols + mcu_x.reshape(-1, 1, 1) * h + bx)
            dest.append(idx.reshape(-1))
            order += [slot] * (h * v)
        per_mcu = len(order)
        slots = order * (mx * my)
    intervals, end = _entropy_intervals(data, start)
    per = restart * per_mcu if restart else len(slots)
    coef = _decode_coefficients(intervals, slots, per,
                                [huff[0, t >> 4] for _, t in members],
                                [huff[1, t & 15] for _, t in members], path)
    if ns == 1:
        grids[members[0][0]].reshape(-1, 64)[dest[0]] = coef
    else:
        slot_of = np.asarray(slots)
        for slot, (ci, _) in enumerate(members):
            grids[ci].reshape(-1, 64)[dest[slot]] = coef[slot_of == slot]
    return end


def read_jpeg(path) -> np.ndarray:
    """The image at ``path``: (H, W) uint8 greyscale or (H, W, 3) uint8 RGB."""
    data = Path(path).read_bytes()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List] = {}
    latched: Dict[int, np.ndarray] = {}
    frame, grids, restart, jfif, adobe = None, None, 0, False, None
    pos = 2
    while pos < len(data):
        marker, body, pos = _next_segment(data, pos, path)
        if marker == 0xDB:
            _quant_tables(body, quant)
        elif marker == 0xC4:
            at = 0
            while at < len(body):
                kind, index = body[at] >> 4, body[at] & 15
                counts = body[at + 1 : at + 17]
                n = sum(counts)
                huff[kind, index] = _lookahead(counts, body[at + 17 : at + 17 + n], kind == 0)
                at += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG (DAC) is not supported")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif 0xC0 <= marker <= 0xCF and marker != 0xC8:
            frame = _frame_header(marker, body, path)
            width, height, comps = frame
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            # Each component's blocks: the interleaved scan's MCU grid, which
            # covers the non-interleaved scan's blocks.
            grids = [np.zeros((max(my * v, -(-height * v // (8 * vmax))),
                               max(mx * h, -(-width * h // (8 * hmax))), 64), np.int16)
                     for _, h, v, _ in comps]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            pos = _scan(body, frame, grids, quant, latched, huff, restart, data, pos, path)
        elif marker == 0xD9:
            break
        elif marker == 0xD8 or 0xD0 <= marker <= 0xD7:
            raise ValueError(f"{path}: unexpected marker 0x{marker:02X} outside a scan")
        # APPn, COM and any other segment: skipped.
    if frame is None or not latched:
        raise ValueError(f"{path}: no scan")
    width, height, comps = frame
    missing = [comps[c][0] for c in range(len(comps)) if c not in latched]
    if missing:
        raise ValueError(f"{path}: the file ends before the scan of component {missing[0]}")
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    planes = []
    for ci, (_, h, v, _) in enumerate(comps):
        grid = grids[ci]
        rows, cols = grid.shape[:2]
        blocks = idct_islow(grid.reshape(-1, 8, 8), latched[ci])
        plane = blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        # The downsampled size, then upsampled to the image and cropped.
        plane = plane[: -(-height * v // vmax), : -(-width * h // hmax)]
        planes.append(upsample(plane, hmax // h, vmax // v)[:height, :width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0].astype(np.uint8))
    # jdapimin.c's guess of the colour space: JFIF means YCbCr, else an
    # Adobe transform of 0 or the component ids "RGB" mean RGB.
    ids = tuple(c[0] for c in comps)
    if not jfif and (adobe == 0 if adobe is not None else ids == (82, 71, 66)):
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)
