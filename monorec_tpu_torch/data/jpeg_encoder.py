"""A baseline JPEG writer in numpy that gives the bytes PIL writes for
``Image.fromarray(rgb).save(path)`` where PIL links libjpeg-turbo (PIL
12.1 with libjpeg-turbo 3.1.3): quality 75, 4:2:0, the standard Huffman
tables, no restart markers. The TSDF export (``utils.save_frame_for_tsdf``)
writes its colour images with it; the port does not use PIL.

It follows libjpeg-turbo's C code, which its SIMD code matches:

* ``jccolor.c::rgb_ycc_convert``: 16-bit fixed-point tables, Y rounded with
  ``ONE_HALF``, Cb and Cr with ``CBCR_OFFSET + ONE_HALF - 1``;
* the edges: the colour-converted rows padded to an even count with a copy
  of the last (``jcprepct.c``), each row padded on the right to its
  component's block columns with a copy of its last sample
  (``jcsample.c::expand_right_edge``), and each downsampled component
  padded at the bottom to a whole MCU row with copies of its last row;
* ``jcsample.c::h2v2_downsample`` for Cb and Cr: the 2x2 sum plus a bias
  of 1, 2, 1, 2, ... along the row, shifted right by 2;
* ``jfdctint.c::jpeg_fdct_islow`` on the samples less 128, and
  ``jcdctmgr.c``'s quantization: libjpeg-turbo multiplies by a reciprocal
  of 8 x the table entry, which equals the division rounded half away from
  zero over the coefficients' range (``tests/test_torch_utils.py`` checks
  it for every 8-bit entry);
* ``jccoefct.c``'s dummy blocks, where the luminance blocks do not fill
  the last MCU column or row: all AC coefficients 0 and the DC of the block
  before it in the MCU;
* ``jcparam.c``'s tables at quality 75 (scale 50, ``(q * 50 + 50) / 100``
  in 1..255), ``jstdhuff.c``'s Huffman tables, ``jchuff.c``'s coding, with
  a 0 byte after each 0xFF and the last byte padded with 1-bits;
* ``jcmarker.c``'s segments: SOI, JFIF 1.01 APP0 (density 1:1, no unit),
  the two DQT, SOF0, the four DHT, SOS, the scan and EOI.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from monorec_tpu_torch.data.jpeg import (
    CONST_BITS, FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865,
    FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065, FIX_1_961570560,
    FIX_2_053119869, FIX_2_562915447, FIX_3_072711026, ONE_HALF, PASS1_BITS, SCALEBITS,
    ZIGZAG, _fix,
)

# jcparam.c's tables (the JPEG standard's Annex K.1 and K.2), natural order.
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
# jstdhuff.c: the count of codes of each length 1-16, then the symbols.
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
CBCR_OFFSET = 128 << SCALEBITS


def quant_table(base: np.ndarray) -> np.ndarray:
    """``jpeg_add_quant_table`` with ``force_baseline`` at quality 75 (a
    scale of 50%): ``base`` scaled and kept in 1..255."""
    return np.clip((base * 50 + 50) // 100, 1, 255)


def _code_table(bits, symbols):
    """(code, length) arrays indexed by symbol, of a canonical Huffman table."""
    code, size = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code[symbols[k]], size[symbols[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def rgb_to_ycc(rgb: np.ndarray):
    """``rgb_ycc_convert`` of (H, W, 3) uint8: Y, Cb, Cr as (H, W) int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b + CBCR_OFFSET + ONE_HALF
          - 1) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b + CBCR_OFFSET + ONE_HALF
          - 1) >> SCALEBITS
    return y, cb, cr


def _pad(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``p`` padded at the bottom and right to ``rows`` x ``cols`` with copies
    of its last row and column."""
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def h2v2_downsample(p: np.ndarray) -> np.ndarray:
    """``h2v2_downsample`` of a plane of even height and width."""
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + np.arange(s.shape[1]) % 2
    return (s + bias) >> 2


def _fdct_pass(v, last: bool):
    """One 1-D pass of ``jpeg_fdct_islow`` over the 8 inputs ``v`` (arrays):
    the row pass (scaled up by 2^PASS1_BITS) or, ``last``, the column pass."""
    tmp0, tmp7 = v[0] + v[7], v[0] - v[7]
    tmp1, tmp6 = v[1] + v[6], v[1] - v[6]
    tmp2, tmp5 = v[2] + v[5], v[2] - v[5]
    tmp3, tmp4 = v[3] + v[4], v[3] - v[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS + PASS1_BITS if last else CONST_BITS - PASS1_BITS

    def descale(x, n=shift):
        return (x + (1 << (n - 1))) >> n

    out = [None] * 8
    if last:
        out[0], out[4] = descale(tmp10 + tmp11, PASS1_BITS), descale(tmp10 - tmp11, PASS1_BITS)
    else:
        out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = descale(z1 + tmp13 * FIX_0_765366865)
    out[6] = descale(z1 + tmp12 * -FIX_1_847759065)

    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = descale(tmp4 + z1 + z3)
    out[5] = descale(tmp5 + z2 + z4)
    out[3] = descale(tmp6 + z2 + z3)
    out[1] = descale(tmp7 + z1 + z4)
    return out


def fdct_quantize(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The quantized coefficients (rows, cols, 64), zig-zag order, of a
    plane of samples whose sides are multiples of 8."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    x = (plane - 128).reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    x = np.stack(_fdct_pass([x[:, :, k] for k in range(8)], False), axis=2)
    x = np.stack(_fdct_pass([x[:, k, :] for k in range(8)], True), axis=1)
    d = 8 * quant.reshape(8, 8)
    q = np.sign(x) * ((np.abs(x) + d // 2) // d)
    return q.reshape(rows, cols, 64)[..., ZIGZAG[:64]]


def _luma_blocks(y: np.ndarray, h: int, w: int, my: int, mx: int) -> np.ndarray:
    """The luminance blocks of ``my`` x ``mx`` MCUs, (2 my, 2 mx, 64): the
    image's blocks, then ``jccoefct.c``'s dummy blocks (AC 0, the DC of the
    block before them in the MCU) where they do not fill the last MCU
    column or row."""
    bh, bw = -(-h // 8), -(-w // 8)
    real = fdct_quantize(_pad(y, 8 * bh, 8 * bw), quant_table(LUMA_QUANT))
    blocks = np.zeros((2 * my, 2 * mx, 64), np.int64)
    blocks[:bh, :bw] = real
    if bw % 2:
        blocks[:bh, bw, 0] = real[:, -1, 0]
    if bh % 2:
        blocks[bh, :, 0] = blocks[bh - 1, 1::2, 0].repeat(2)
    return blocks


def _magnitude(v: np.ndarray):
    """(category, magnitude bits) of coefficients or DC differences."""
    s = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return s, np.where(v >= 0, v, v + (1 << s) - 1)


def _scan(blocks: np.ndarray, table: np.ndarray) -> bytes:
    """The entropy-coded data of (N, 64) zig-zag blocks in coding order
    (their DC already the difference to the component's last), block ``i``
    coded with Huffman tables ``table[i]`` (0 luminance, 1 chrominance)."""
    dc_codes = [_code_table(*DC_LUMA), _code_table(*DC_CHROMA)]
    ac_codes = [_code_table(*AC_LUMA), _code_table(*AC_CHROMA)]
    n = len(blocks)
    # Each emitted bit string is (sort key, code, length); the key orders
    # them by block, then coefficient, then DC / ZRL / symbol / magnitude.
    keys, codes, lengths = [], [], []

    def emit(key, code, length):
        keys.append(key)
        codes.append(code)
        lengths.append(length)

    base = np.arange(n, dtype=np.int64) * 1024
    s, mag = _magnitude(blocks[:, 0])
    for t in (0, 1):
        on = table == t
        emit(base[on], dc_codes[t][0][s[on]], dc_codes[t][1][s[on]])
    emit(base + 1, mag, s)

    bi, ki = np.nonzero(blocks[:, 1:])
    k = ki + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s, mag = _magnitude(blocks[bi, k])
    sym = (run % 16) << 4 | s
    zrl = run // 16
    at = bi * 1024 + k * 4
    for t in (0, 1):
        on = table[bi] == t
        z = np.repeat(at[on], zrl[on])
        emit(z, np.full(len(z), ac_codes[t][0][0xF0]), np.full(len(z), ac_codes[t][1][0xF0]))
        emit(at[on] + 1, ac_codes[t][0][sym[on]], ac_codes[t][1][sym[on]])
    emit(at + 2, mag, s)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)  # each block's last non-zero coefficient
    for t in (0, 1):
        on = (last < 63) & (table == t)
        emit(base[on] + 4 * 64, np.full(on.sum(), ac_codes[t][0][0]),
             np.full(on.sum(), ac_codes[t][1][0]))

    order = np.argsort(np.concatenate(keys), kind="stable")
    codes = np.concatenate(codes)[order]
    lengths = np.concatenate(lengths)[order]
    starts = np.cumsum(lengths) - lengths
    idx = np.arange(int(lengths.sum())) - np.repeat(starts, lengths)
    bits = (np.repeat(codes, lengths) >> (np.repeat(lengths, lengths) - 1 - idx)) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])
    return np.packbits(bits.astype(np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb) -> bytes:
    """The JPEG file of an (H, W, 3) uint8 RGB array, as PIL writes it."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"encode_jpeg takes a non-empty uint8 (H, W, 3) array, not "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    my, mx = -(-h // 16), -(-w // 16)
    y, cb, cr = rgb_to_ycc(rgb)
    grids = [_luma_blocks(y, h, w, my, mx)]
    for p in (cb, cr):
        small = h2v2_downsample(_pad(p, h + h % 2, 16 * mx))
        grids.append(fdct_quantize(_pad(small, 8 * my, 8 * mx), quant_table(CHROMA_QUANT)))
    # Coding order: per MCU the four luminance blocks row by row, Cb, Cr.
    luma = grids[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    blocks = np.concatenate([luma, grids[1][:, :, None], grids[2][:, :, None]], axis=2)
    blocks = blocks.reshape(-1, 6, 64)
    for slots in (slice(0, 4), slice(4, 5), slice(5, 6)):  # each component's DC predictor
        dc = blocks[:, slots, 0].reshape(-1)
        blocks[:, slots, 0] = np.diff(dc, prepend=0).reshape(-1, slots.stop - slots.start)
    table = np.tile([0, 0, 0, 0, 1, 1], my * mx)

    jfif = _segment(0xE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
    dqt = b"".join(_segment(0xDB, bytes([i]) + bytes(quant_table(base)[ZIGZAG[:64]].tolist()))
                   for i, base in enumerate((LUMA_QUANT, CHROMA_QUANT)))
    sof = _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                                   3, 0x11, 1]))
    dht = b"".join(_segment(0xC4, bytes([index]) + bytes(bits) + symbols) for index, (bits, symbols)
                   in ((0x00, DC_LUMA), (0x10, AC_LUMA), (0x01, DC_CHROMA), (0x11, AC_CHROMA)))
    sos = _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return (b"\xff\xd8" + jfif + dqt + sof + dht + sos + _scan(blocks.reshape(-1, 64), table)
            + b"\xff\xd9")


def write_jpeg(path, rgb) -> None:
    """Write an (H, W, 3) uint8 RGB array as ``Image.fromarray(rgb).save(path)``
    writes it (``encode_jpeg``)."""
    Path(path).write_bytes(encode_jpeg(rgb))
