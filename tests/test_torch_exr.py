"""The port's OpenEXR reader (``data/exr.py``) against
``chip_smoke.encode_exr``, a writer from the OpenEXR file layout (the
tests have no EXR library to hold it to, and a cv2 built without OpenEXR
reads no EXR), and ``resize_bilinear_float`` against Pillow's mode F.

* Every compression (NONE, RLE, ZIPS, ZIP), pixel type (HALF, FLOAT) and
  line order (increasing, decreasing y) the reader takes, for one channel
  ``Y`` and for ``R, G, B`` (returned B, G, R as cv2 does), at sizes that
  do and do not fill the last ZIP chunk, with data windows at and off the
  origin: the written arrays exactly (HALF through ``np.float16``),
  inf, NaN and -0.0 included.
* Noise, which no compression shrinks: its chunks are stored raw.
* Each file the reader refuses raises naming why.
* ``resize_bilinear_float``: downscales and upscales, one axis or both,
  equal to Pillow's ``Image.fromarray(float32).resize(BILINEAR)`` exactly
  (bit for bit, not within an ulp).
"""

import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from monorec_tpu_torch.data.exr import read_exr
from monorec_tpu_torch.data.resize import resize_bilinear_float

SHAPES = ((1, 1), (5, 7), (16, 9), (37, 21))
ORIGINS = ((0, 0), (4, -7))


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    depth = np.fromfunction(lambda y, x: 10 + 0.25 * y + 0.01 * x, shape).astype(np.float32)
    depth[rng.random(shape) < 0.3] = 0.0  # holes: runs for RLE
    noise = (rng.normal(size=shape) * 100).astype(np.float32)
    noise.flat[0] = np.inf
    noise.flat[-1] = -0.0
    if noise.size > 2:
        noise.flat[1] = np.nan
    return {"depth": depth, "noise": noise}


def _expected(a, pixel_type):
    return a.astype(np.float16).astype(np.float32) if pixel_type == "HALF" else a


@pytest.mark.parametrize("line_order", ["INCREASING_Y", "DECREASING_Y"])
@pytest.mark.parametrize("pixel_type", ["HALF", "FLOAT"])
@pytest.mark.parametrize("compression", ["NONE", "RLE", "ZIPS", "ZIP"])
def test_read_exr_matches_written(tmp_path, compression, pixel_type, line_order):
    path = tmp_path / "x.exr"
    for s, shape in enumerate(SHAPES):
        for kind, a in _arrays(shape, s).items():
            for origin in ORIGINS:
                options = dict(compression=compression, pixel_type=pixel_type,
                               line_order=line_order, origin=origin)
                path.write_bytes(chip_smoke.encode_exr(a, **options))
                got = read_exr(path)
                assert got.dtype == np.float32 and got.shape == shape
                np.testing.assert_array_equal(got, _expected(a, pixel_type), err_msg=kind)
                assert np.array_equal(np.signbit(got), np.signbit(_expected(a, pixel_type)))
                rgb = {"R": a, "G": 2 * a, "B": a + 1}
                path.write_bytes(chip_smoke.encode_exr(rgb, **options))
                got = read_exr(path)
                want = np.stack([rgb["B"], rgb["G"], rgb["R"]], axis=-1)
                assert got.dtype == np.float32 and got.shape == shape + (3,)
                np.testing.assert_array_equal(got, _expected(want, pixel_type), err_msg=kind)


def _chunk_sizes(data: bytes, n_chunks: int, header_end: int):
    offsets = struct.unpack(f"<{n_chunks}Q", data[header_end : header_end + 8 * n_chunks])
    return [struct.unpack("<ii", data[o : o + 8])[1] for o in offsets]


@pytest.mark.parametrize("compression", ["RLE", "ZIPS", "ZIP"])
def test_read_exr_raw_stored_chunks(tmp_path, compression):
    """A chunk that compression does not shrink is stored raw (its size the
    raw size); rows of one depth and a hole do shrink. Both read back
    exactly."""
    path = tmp_path / "x.exr"
    h, w = 20, 32
    per = 16 if compression == "ZIP" else 1
    rows = np.repeat((10 + 0.25 * np.arange(h, dtype=np.float32))[:, None], w, axis=1)
    rows[:, w // 2 :] = 0.0
    for kind, a in (("rows", rows), ("noise", _arrays((h, w), 1)["noise"])):
        data = chip_smoke.encode_exr(a, compression)
        header_end = len(chip_smoke.encode_exr(a, "NONE")) - 8 * h - h * (8 + 4 * w)
        sizes = _chunk_sizes(data, -(-h // per), header_end)
        raw = [min(per, h - i * per) * 4 * w for i in range(len(sizes))]
        if kind == "noise":
            assert sizes == raw
        else:
            assert all(s < r for s, r in zip(sizes, raw))
        path.write_bytes(data)
        np.testing.assert_array_equal(read_exr(path), a)


def _patched(field: bytes, value: bytes, skip: int = 4):
    """A writer of a NONE file whose bytes ``skip`` after ``field`` (an
    attribute's name and type name, before its size) are ``value``."""
    def write(path):
        data = chip_smoke.encode_exr(np.ones((4, 4), np.float32), "NONE")
        at = data.index(field) + len(field) + skip
        path.write_bytes(data[:at] + value + data[at + len(value):])
    return write


def _version(flags: int):
    def write(path):
        data = chip_smoke.encode_exr(np.ones((4, 4), np.float32), "NONE")
        path.write_bytes(data[:4] + struct.pack("<I", 2 | flags) + data[8:])
    return write


def _channels(names, pixel_type="FLOAT"):
    def write(path):
        path.write_bytes(chip_smoke.encode_exr({n: np.ones((4, 4)) for n in names}, "NONE",
                                               pixel_type))
    return write


def _not_exr(path):
    chip_smoke.write_png(path, np.zeros((8, 8), np.uint8))


def _truncated(path):
    data = chip_smoke.encode_exr(np.ones((16, 16), np.float32), "ZIPS")
    path.write_bytes(data[: len(data) - 20])


REFUSALS = {
    "tiled": (_version(0x200), "tiled OpenEXR is not supported"),
    "deep": (_version(0x800), "deep OpenEXR is not supported"),
    "multi_part": (_version(0x1000), "multi-part OpenEXR is not supported"),
    "uint": (_channels(["Y"], "UINT"), "UINT, which is not supported"),
    "z_channel": (_channels(["Z"]), r"channels \['Z'\] are not supported"),
    "rgba": (_channels(["R", "G", "B", "A"]), "are not supported"),
    "not_exr": (_not_exr, "not an OpenEXR file"),
    "truncated": (_truncated, "truncated"),
    "subsampled": (_patched(b"Y\x00", struct.pack("<iB3xii", 2, 0, 2, 2), skip=0),
                   "subsampled"),
    **{name: (_patched(b"compression\x00compression\x00", bytes((code,))),
              f"{name} compression is not supported")
       for code, name in enumerate(("PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB"), start=4)},
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_read_exr_raises_on_what_it_does_not_read(tmp_path, case):
    write, message = REFUSALS[case]
    path = tmp_path / "x.exr"
    write(path)
    with pytest.raises(ValueError, match=message):
        read_exr(path)


RESIZES = {
    "down_both": ((40, 80), (32, 64)),
    "down_3x": ((60, 90), (20, 30)),
    "up_both": ((7, 5), (23, 17)),
    "width_only": ((40, 80), (40, 31)),
    "height_only": ((40, 80), (13, 80)),
    "to_one": ((9, 1), (1, 1)),
    "same": ((12, 14), (12, 14)),
}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_bilinear_float_matches_pil(case):
    (h, w), (th, tw) = RESIZES[case]
    rng = np.random.default_rng(len(case))
    for a in ((rng.random((h, w)) * 80).astype(np.float32),
              (rng.normal(size=(h, w)) * 1e4).astype(np.float32),
              np.where(rng.random((h, w)) < 0.4, 0, rng.random((h, w)) * 50).astype(np.float32)):
        want = np.asarray(Image.fromarray(a).resize((tw, th), Image.BILINEAR))
        got = resize_bilinear_float(a, (th, tw))
        assert got.dtype == np.float32 and got.shape == (th, tw)
        np.testing.assert_array_equal(got, want)
