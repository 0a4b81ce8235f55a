"""The port's baseline greyscale JPEG decoder (``data/jpeg.py``) against PIL
(libjpeg-turbo), byte for byte.

Files written by PIL at qualities 10-100, at sizes that are and are not
multiples of 8, plain, with restart markers every few blocks or every block
row, with optimized Huffman tables, with 16-bit quantization tables (SOF1),
on smooth images and on noise (large coefficients at high quality); files
written by ``chip_smoke.encode_jpeg`` (the card's machine has no JPEG
writer); coefficients written directly (``jpeg_from_coefficients``), up to
where the IDCT's values leave [-512, 511] (PIL's SIMD IDCT and the C code
part there, see the module).
Colour, progressive, arithmetic-coded and non-JPEG files raise.
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


def test_range_limit_table():
    """jdmaster.c's post-IDCT table: x + 128 clamped for x in [-512, 511]."""
    x = np.arange(-512, 512)
    np.testing.assert_array_equal(jpeg._RANGE_LIMIT[x & jpeg.RANGE_MASK],
                                  np.clip(x + 128, 0, 255))


def _colour(path):
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(path)


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
    (_colour, "colour JPEG is not supported"), (_progressive, "progressive"),
    (_arithmetic, "arithmetic-coded"), (_png, "not a JPEG"), (_truncated_scan, "ends inside block"),
    (_truncated_header, "ends before its scan"),
])
def test_read_jpeg_raises_on_what_it_does_not_read(tmp_path, write, message):
    path = tmp_path / "x.jpg"
    write(path)
    with pytest.raises(ValueError, match=message):
        read_jpeg(path)
