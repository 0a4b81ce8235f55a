"""The port's baseline JPEG decoder (``data/jpeg.py``) against PIL
(libjpeg-turbo), byte for byte, greyscale and colour.

Files written by PIL at qualities 10-100, at sizes that are and are not
multiples of 8, plain, with restart markers every few blocks or every block
row, with optimized Huffman tables, with 16-bit quantization tables (SOF1),
on smooth images and on noise (large coefficients at high quality); files
written by ``chip_smoke.encode_jpeg`` (the card's machine has no JPEG
writer); coefficients written directly (``jpeg_from_coefficients``), up to
where the IDCT's values leave [-512, 511] (PIL's SIMD IDCT and the C code
part there, see the module).
Colour: files written by PIL at 4:4:4, 4:2:2 and 4:2:0, qualities 50-100,
at odd sizes and at widths whose chroma is 1-2 samples wide (where
libjpeg-turbo upsamples by replication), with restart intervals; files
written by ``chip_smoke.encode_jpeg``, which PIL cannot write: 4:4:0
(h1v2), mixed sampling factors, each component in a scan of its own, and
Adobe transform-0 RGB; and the same encoder's 4:2:0 files decoded by PIL.
CMYK, progressive, arithmetic-coded and non-JPEG files raise.
"""

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from monorec_tpu_torch.data import jpeg
from monorec_tpu_torch.data.jpeg import jpeg_size, read_jpeg

SIZES = ((8, 8), (16, 24), (13, 21), (37, 61), (1, 130))
OPTIONS = {
    "plain": {},
    "restart_blocks": {"restart_marker_blocks": 3},
    "restart_rows": {"restart_marker_rows": 1},
    "optimize": {"optimize": True},
}


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 5.0) + rng.normal(0, 6, (h, w))
    return {"smooth": np.clip(smooth, 0, 255).astype(np.uint8),
            "noise": rng.integers(0, 256, (h, w), dtype=np.uint8)}


def _assert_decodes_like_pil(path):
    want = np.asarray(Image.open(path))
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert jpeg_size(path) == Image.open(path).size


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_read_jpeg_matches_pil(tmp_path, quality, option):
    for s, (h, w) in enumerate(SIZES):
        for kind, img in _images(h, w, s).items():
            path = tmp_path / f"{h}x{w}_{kind}.jpg"
            Image.fromarray(img).save(path, quality=quality, **OPTIONS[option])
            _assert_decodes_like_pil(path)


def test_read_jpeg_16bit_tables_match_pil(tmp_path):
    """Quantization entries past 255 make PIL write 16-bit DQT entries and
    an SOF1 (extended sequential) frame."""
    table = [min(16 + 40 * i, 1000) for i in range(64)]
    for s, (h, w) in enumerate(SIZES):
        path = tmp_path / f"{h}x{w}.jpg"
        Image.fromarray(_images(h, w, s)["smooth"]).save(path, qtables=[table])
        data = path.read_bytes()
        assert b"\xff\xc1" in data and data[data.index(b"\xff\xdb") + 4] >> 4 == 1
        _assert_decodes_like_pil(path)


@pytest.mark.parametrize("quality,restart", [(90, 0), (90, 61), (50, 1), (100, 7), (30, 0)])
def test_chip_smoke_encoder_decodes_alike(tmp_path, quality, restart):
    for s, (h, w) in enumerate(SIZES + ((64, 96),)):
        path = tmp_path / f"{h}x{w}.jpg"
        img = _images(h, w, s)["smooth"]
        chip_smoke.write_jpeg(path, img, quality=quality, restart_interval=restart)
        _assert_decodes_like_pil(path)
        assert np.abs(read_jpeg(path).astype(int) - img).mean() < 8


@pytest.mark.parametrize("amp", [8, 30, 100])
def test_read_jpeg_on_written_coefficients(tmp_path, amp):
    """Coefficients written straight into the file (quantization table of
    1s), the IDCT's output reaching past +-255 but inside [-512, 511]."""
    for seed in range(8):
        coef = np.random.default_rng(seed).integers(-amp, amp + 1, (6, 64))
        path = tmp_path / f"{seed}.jpg"
        path.write_bytes(chip_smoke.jpeg_from_coefficients(coef, np.ones((8, 8), int), 16, 24))
        _assert_decodes_like_pil(path)


COLOUR_SIZES = ((16, 16), (37, 53), (9, 17), (5, 1), (3, 2), (7, 3), (2, 4), (1, 130))


def _colour_images(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([128 + 60 * np.sin(x / 7.0 + c) * np.cos(y / 5.0) for c in range(3)], -1)
    smooth = np.clip(smooth + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    return {"smooth": smooth, "noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)}


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_read_jpeg_colour_matches_pil(tmp_path, quality, subsampling):
    """Widths 1-4 leave chroma 1-2 samples wide at 4:2:x: libjpeg-turbo then
    replicates instead of its triangle filter."""
    for s, (h, w) in enumerate(COLOUR_SIZES):
        for kind, img in _colour_images(h, w, s).items():
            for option in ("plain", "restart_blocks", "optimize"):
                path = tmp_path / f"{h}x{w}_{kind}_{option}.jpg"
                Image.fromarray(img).save(path, quality=quality, subsampling=subsampling,
                                          **OPTIONS[option])
                _assert_decodes_like_pil(path)


SAMPLINGS = {
    "h1v2": ((1, 2), (1, 1), (1, 1)),
    "mixed": ((2, 2), (2, 1), (1, 2)),
    "chroma_finer": ((1, 1), (2, 2), (1, 1)),
    "h2v2": ((2, 2), (1, 1), (1, 1)),
}


@pytest.mark.parametrize("separate", [False, True], ids=["interleaved", "separate_scans"])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_chip_smoke_colour_encoder_decodes_alike(tmp_path, sampling, separate):
    """What PIL cannot write: 4:4:0, sampling factors that differ between
    the chroma components, each component in a scan of its own; with and
    without restart intervals (counted in MCUs when interleaved)."""
    for s, (h, w) in enumerate(COLOUR_SIZES + ((64, 96),)):
        img = _colour_images(h, w, s)["smooth"]
        for restart in (0, 1, 5):
            path = tmp_path / f"{h}x{w}_{restart}.jpg"
            path.write_bytes(chip_smoke.encode_jpeg(img, 90, restart, SAMPLINGS[sampling],
                                                    separate))
            _assert_decodes_like_pil(path)


def test_read_jpeg_adobe_rgb(tmp_path):
    """An Adobe APP14 segment with transform 0 and no JFIF: the components
    are R, G and B, not converted."""
    for s, (h, w) in enumerate(COLOUR_SIZES):
        img = _colour_images(h, w, s)["smooth"]
        for sampling in (SAMPLINGS["h2v2"], ((1, 1),) * 3):
            path = tmp_path / f"{h}x{w}.jpg"
            path.write_bytes(chip_smoke.encode_jpeg(img, 95, 0, sampling, adobe_rgb=True))
            assert b"Adobe" in path.read_bytes() and b"JFIF" not in path.read_bytes()
            _assert_decodes_like_pil(path)


def test_chip_smoke_colour_encoder_quality(tmp_path):
    """PIL decodes the encoder's default files (4:2:0, as phase 27 writes
    most frames) as the port does, near the source."""
    y, x = np.mgrid[0:64, 0:96]
    img = np.stack([128 + 60 * np.sin(x / 9.0 + c) * np.cos(y / 7.0) for c in range(3)], -1)
    img = np.round(img).astype(np.uint8)
    for restart in (0, 61):
        path = tmp_path / f"{restart}.jpg"
        chip_smoke.write_jpeg(path, img, quality=90, restart_interval=restart)
        _assert_decodes_like_pil(path)
        assert np.abs(read_jpeg(path).astype(int) - img).mean() < 2


def test_range_limit_table():
    """jdmaster.c's post-IDCT table: x + 128 clamped for x in [-512, 511]."""
    x = np.arange(-512, 512)
    np.testing.assert_array_equal(jpeg._RANGE_LIMIT[x & jpeg.RANGE_MASK],
                                  np.clip(x + 128, 0, 255))


def _cmyk(path):
    Image.fromarray(np.zeros((16, 16, 4), np.uint8), "CMYK").save(path)


def _progressive(path):
    Image.fromarray(_images(16, 16, 0)["smooth"]).save(path, progressive=True)


def _arithmetic(path):
    Image.fromarray(_images(16, 16, 0)["smooth"]).save(path)
    data = bytearray(path.read_bytes())
    data[data.index(b"\xff\xc0") + 1] = 0xC9  # SOF0 -> SOF9
    path.write_bytes(bytes(data))


def _png(path):
    chip_smoke.write_png(path, np.zeros((8, 8), np.uint8))


def _truncated_scan(path):
    Image.fromarray(_images(32, 32, 0)["noise"]).save(path, quality=95)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) - len(data) // 3])


def _truncated_header(path):
    Image.fromarray(_images(32, 32, 0)["noise"]).save(path, quality=95)
    path.write_bytes(path.read_bytes()[:200])


@pytest.mark.parametrize("write,message", [
    (_cmyk, "CMYK/YCCK JPEG is not supported"), (_progressive, "progressive"),
    (_arithmetic, "arithmetic-coded"), (_png, "not a JPEG"), (_truncated_scan, "ends inside block"),
    (_truncated_header, "ends before its scan"),
])
def test_read_jpeg_raises_on_what_it_does_not_read(tmp_path, write, message):
    path = tmp_path / "x.jpg"
    write(path)
    with pytest.raises(ValueError, match=message):
        read_jpeg(path)
