"""The port's JPEG decoder (``data/jpeg.py``) against PIL (libjpeg-turbo),
byte for byte, greyscale, colour and CMYK, sequential and progressive.

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
Progressive: files written by PIL (libjpeg's ``jpeg_simple_progression``,
optimized tables before most scans) greyscale and at 4:4:4, 4:2:2 and
4:2:0, qualities 50-100, at odd sizes, smooth (long EOBRUNs) and noise,
with restart intervals of blocks and of rows; files written by
``chip_smoke.encode_jpeg``, each decoding equal to its baseline twin (the
same quantized coefficients) and as PIL decodes it. Four components: PIL's
CMYK at 4:4:4 and 4:2:0, sequential and progressive, the same files with
their Adobe transform set to 2 (which PIL then decodes as YCCK) and with
their APP14 segment removed, and ``chip_smoke.encode_jpeg``'s CMYK and
YCCK; ``cmyk_to_rgb`` against PIL's ``convert("RGB")`` on every (C, K)
pair. A progressive script that leaves a coefficient short of full
precision (libjpeg would smooth its blocks), two components,
arithmetic-coded and non-JPEG files raise.
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


def _unrefined(path):
    """A progressive file whose script never takes the luma's AC 1-63 from
    Al=1 to 0: libjpeg would smooth its blocks."""
    script = [s for s in chip_smoke.progressive_script(3) if s[0] != (0,) or s[3:] != (1, 0)]
    path.write_bytes(chip_smoke.encode_jpeg(_colour_images(16, 16, 0)["smooth"],
                                            progressive=script))


def _two_components(path):
    grid = np.zeros((2, 2, 64), np.int64)
    q = np.ones(64, np.int64)
    path.write_bytes(chip_smoke.jpeg_from_components([grid, grid], [(1, 1), (1, 1)], [q, q],
                                                     16, 16))


def _sof10(path):
    Image.fromarray(_images(16, 16, 0)["smooth"]).save(path, progressive=True)
    data = bytearray(path.read_bytes())
    data[data.index(b"\xff\xc2") + 1] = 0xCA  # SOF2 -> SOF10
    path.write_bytes(bytes(data))


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
    (_unrefined, "coefficient 1 of component 1 short of full precision.*block smoothing"),
    (_two_components, "2 components are not supported"),
    (_sof10, r"arithmetic-coded progressive \(SOF10\)"), (_arithmetic, "arithmetic-coded"), (_png, "not a JPEG"), (_truncated_scan, "ends inside block"),
    (_truncated_header, "ends before its scan"),
])
def test_read_jpeg_raises_on_what_it_does_not_read(tmp_path, write, message):
    path = tmp_path / "x.jpg"
    write(path)
    with pytest.raises(ValueError, match=message):
        read_jpeg(path)


# ----- progressive ----------------------------------------------------------------

PROGRESSIVE_SIZES = ((8, 8), (13, 21), (37, 61), (64, 80), (1, 130))
PROGRESSIVE_OPTIONS = {"plain": {}, "restart_blocks": {"restart_marker_blocks": 3},
                       "restart_rows": {"restart_marker_rows": 1}}


@pytest.mark.parametrize("option", sorted(PROGRESSIVE_OPTIONS))
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_read_progressive_grey_matches_pil(tmp_path, quality, option):
    for s, (h, w) in enumerate(PROGRESSIVE_SIZES):
        for kind, img in _images(h, w, s).items():
            path = tmp_path / f"{h}x{w}_{kind}.jpg"
            Image.fromarray(img).save(path, quality=quality, progressive=True,
                                      **PROGRESSIVE_OPTIONS[option])
            assert b"\xff\xc2" in path.read_bytes()
            _assert_decodes_like_pil(path)


@pytest.mark.parametrize("option", sorted(PROGRESSIVE_OPTIONS))
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_read_progressive_colour_matches_pil(tmp_path, quality, subsampling, option):
    for s, (h, w) in enumerate(((16, 16), (37, 53), (9, 17), (64, 80), (3, 2))):
        for kind, img in _colour_images(h, w, s).items():
            path = tmp_path / f"{h}x{w}_{kind}.jpg"
            Image.fromarray(img).save(path, quality=quality, subsampling=subsampling,
                                      progressive=True, **PROGRESSIVE_OPTIONS[option])
            _assert_decodes_like_pil(path)


def test_progressive_smooth_image_codes_long_eob_runs(tmp_path):
    """A flat image: the AC scans are end-of-band runs over whole block
    rows (EOBRUN), with their correction bits in the refinement scans."""
    y, x = np.mgrid[0:64, 0:80]
    img = np.stack([100 + x // 2, 120 + 0 * x, 90 + y // 3], -1).astype(np.uint8)
    for subsampling in (0, 2):
        path = tmp_path / f"{subsampling}.jpg"
        Image.fromarray(img).save(path, quality=95, subsampling=subsampling, progressive=True)
        _assert_decodes_like_pil(path)


# ----- four components --------------------------------------------------------------


def _cmyk_images(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([128 + 60 * np.sin(x / 7.0 + c) * np.cos(y / 5.0) for c in range(4)], -1)
    smooth = np.clip(smooth + rng.normal(0, 6, (h, w, 4)), 0, 255).astype(np.uint8)
    return {"smooth": smooth, "noise": rng.integers(0, 256, (h, w, 4), dtype=np.uint8)}


def _adobe_variants(data: bytes) -> dict:
    """PIL's CMYK file as written, with its Adobe transform set to 2 (YCCK)
    and without its APP14 segment (plain CMYK)."""
    at = data.index(b"Adobe")
    ycck = bytearray(data)
    ycck[at + 11] = 2
    length = int.from_bytes(data[at - 2 : at], "big")
    return {"cmyk": data, "ycck": bytes(ycck), "no_app14": data[: at - 4] + data[at - 2 + length :]}


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_read_cmyk_and_ycck_match_pil(tmp_path, subsampling, progressive):
    """PIL writes C at 2x2 and M, Y, K at 1x1 for 4:2:0, and inverts every
    four-component file it reads (``CMYK;I``)."""
    for s, (h, w) in enumerate(((16, 16), (13, 21), (64, 80), (2, 5))):
        for kind, img in _cmyk_images(h, w, s).items():
            path = tmp_path / "x.jpg"
            Image.fromarray(img, "CMYK").save(path, quality=90, subsampling=subsampling,
                                              progressive=progressive)
            for name, data in _adobe_variants(path.read_bytes()).items():
                path.write_bytes(data)
                assert Image.open(path).mode == "CMYK"
                _assert_decodes_like_pil(path)


def test_cmyk_to_rgb_matches_pil_convert():
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, (7 * c + k) % 256, 255 - c, k], -1).astype(np.uint8)
    np.testing.assert_array_equal(jpeg.cmyk_to_rgb(cmyk),
                                  np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB")))


# ----- chip_smoke's encoder -------------------------------------------------------------


ENCODER_CASES = {
    "grey": (0, {}), "420": (3, {}), "444": (3, {"sampling": ((1, 1),) * 3}),
    "mixed": (3, {"sampling": SAMPLINGS["mixed"]}), "adobe_rgb": (3, {"adobe_rgb": True}),
    "cmyk": (4, {"sampling": ((1, 1),) * 4}), "cmyk_c2x2": (4, {}),
    "ycck": (4, {"ycck": True, "sampling": ((2, 1), (1, 1), (1, 1), (1, 2))}),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_chip_smoke_progressive_decodes_like_its_baseline_twin(tmp_path, case):
    """The encoder's progressive files (libjpeg's scan script, its own
    optimal tables) decode equal to the baseline file of the same
    coefficients, and as PIL decodes them; with and without restart
    intervals."""
    channels, kwargs = ENCODER_CASES[case]
    for s, (h, w) in enumerate(((16, 16), (37, 53), (64, 80), (1, 130))):
        img = _cmyk_images(h, w, s)["smooth"]
        img = img[..., 0] if channels == 0 else img[..., :channels]
        for restart in (0, 1, 7):
            twin = tmp_path / "baseline.jpg"
            twin.write_bytes(chip_smoke.encode_jpeg(img, 90, restart, **kwargs))
            path = tmp_path / "progressive.jpg"
            path.write_bytes(chip_smoke.encode_jpeg(img, 90, restart, progressive=True, **kwargs))
            assert path.read_bytes().count(b"\xff\xda") > 5
            _assert_decodes_like_pil(twin)
            _assert_decodes_like_pil(path)
            np.testing.assert_array_equal(read_jpeg(path), read_jpeg(twin))


@pytest.mark.parametrize("ycck", [False, True], ids=["cmyk", "ycck"])
def test_chip_smoke_cmyk_is_near_its_source(tmp_path, ycck):
    """What PIL reads back from the encoder's CMYK/YCCK files is the array
    written, within JPEG's loss."""
    y, x = np.mgrid[0:64, 0:80]
    img = np.stack([128 + 60 * np.sin(x / 9.0 + c) * np.cos(y / 7.0) for c in range(4)], -1)
    img = np.round(img).astype(np.uint8)
    path = tmp_path / "x.jpg"
    path.write_bytes(chip_smoke.encode_jpeg(img, 90, ycck=ycck, progressive=True))
    assert path.read_bytes()[path.read_bytes().index(b"Adobe") + 11] == (2 if ycck else 0)
    _assert_decodes_like_pil(path)
    assert np.abs(read_jpeg(path).astype(int) - img).mean() < chip_smoke.JPEG_LEVELS
