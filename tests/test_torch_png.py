"""The port's PNG reader and crop-and-resize against PIL, which the JAX
package's KITTI reader uses: both must give PIL's arrays exactly.

* ``read_png`` equals ``np.asarray(Image.open(p))`` for 8-bit greyscale,
  8-bit RGB and 16-bit greyscale files that PIL wrote from random and from
  smooth images (PIL's encoder picks each row's filter; across these files,
  saved with and without ``optimize``, it picks all five), and for files
  ``chip_smoke.encode_png`` writes with filter ``row % 5`` and three IDAT
  chunks. Palette, alpha, bit depths below 8, interlacing and a bad CRC
  raise.
* ``crop_resize_bilinear`` is uint8-equal to ``crop(box).resize((tw, th),
  BILINEAR)`` at KITTI's two native sizes read at 256x512 with the box of
  ``compute_crop_and_intrinsics``, on an upscale, and in greyscale.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from monorec_tpu_torch.data.kitti import compute_crop_and_intrinsics
from monorec_tpu_torch.data.png import png_size, read_png
from monorec_tpu_torch.data.resize import crop_resize_bilinear


def _image(kind: str, content: str, h: int = 37, w: int = 53, seed: int = 0):
    rng = np.random.default_rng(seed)
    channels = 3 if kind == "RGB" else 1
    if content == "random":
        hi = 65536 if kind == "I;16" else 256
        img = rng.integers(0, hi, (h, w, channels))
    else:
        v, u = np.mgrid[0:h, 0:w]
        img = np.stack([127 + 120 * np.sin(u / (7.0 + c) + c) * np.cos(v / (5.0 + c))
                        for c in range(channels)], -1)
        if kind == "I;16":
            img = img * 257
    img = img.astype(np.uint16 if kind == "I;16" else np.uint8)
    return img[..., 0] if channels == 1 else img


def _filters(path):
    """The filter type of each row of a PNG (IDAT chunks joined)."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, colour = header[:4]
    stride = 1 + w * (3 if colour == 2 else 1) * depth // 8
    raw = zlib.decompress(idat)
    return {raw[r * stride] for r in range(h)}


@pytest.mark.parametrize("content", ["random", "smooth"])
@pytest.mark.parametrize("kind", ["L", "RGB", "I;16"])
def test_read_png_equals_pil(tmp_path, kind, content):
    img = _image(kind, content)
    path = tmp_path / "img.png"
    Image.fromarray(img).save(path)
    ref = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert png_size(path) == Image.open(path).size


def test_pil_files_use_every_filter(tmp_path):
    used = set()
    for kind in ("L", "RGB", "I;16"):
        for content in ("random", "smooth"):
            for optimize in (False, True):  # PIL tries Average only when optimizing
                path = tmp_path / f"{kind.replace(';', '')}_{content}_{optimize}.png"
                Image.fromarray(_image(kind, content, 64, 96)).save(path, optimize=optimize)
                used |= _filters(path)
                np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))
    assert used == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("kind", ["L", "RGB", "I;16"])
def test_read_png_every_filter_by_row_three_idat(tmp_path, kind):
    img = _image(kind, "smooth", 23, 41, seed=2)
    path = tmp_path / "cycled.png"
    chip_smoke.write_png(path, img)
    assert _filters(path) == {0, 1, 2, 3, 4}
    assert open(path, "rb").read().count(b"IDAT") == 3
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def _with_header_byte(data: bytes, offset: int, value: int) -> bytes:
    """The PNG ``data`` with IHDR body byte ``offset`` set and the CRC redone."""
    body = bytearray(data[16:29])
    body[offset] = value
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
    return data[:16] + bytes(body) + crc + data[33:]


@pytest.mark.parametrize("case,match", [
    ("palette", "palette"), ("rgba", "alpha"), ("la", "alpha"), ("one_bit", "bit depth 1"),
    ("interlaced", "interlaced"), ("crc", "CRC"), ("not_png", "not a PNG")])
def test_read_png_rejects_what_it_does_not_read(tmp_path, case, match):
    path = tmp_path / "bad.png"
    img = _image("RGB", "random", 8, 8)
    if case == "palette":
        Image.fromarray(img).convert("P").save(path)
    elif case == "rgba":
        Image.fromarray(img).convert("RGBA").save(path)
    elif case == "la":
        Image.fromarray(img).convert("LA").save(path)
    elif case == "one_bit":
        Image.fromarray(img).convert("1").save(path)
    else:
        data = chip_smoke.encode_png(img)
        if case == "interlaced":
            data = _with_header_byte(data, 12, 1)
        elif case == "crc":
            i = data.index(b"IDAT") + 6
            data = data[:i] + bytes([data[i] ^ 1]) + data[i + 1 :]
        else:
            data = b"GIF89a" + data[6:]
        path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        read_png(path)


def _pil_crop_resize(img, box, size):
    return np.asarray(Image.fromarray(img).crop(box).resize((size[1], size[0]), Image.BILINEAR))


P2 = np.asarray(chip_smoke.KITTI_CALIB["P2"]).reshape(3, 4)


@pytest.mark.parametrize("native,target,kind", [
    ((376, 1241), (256, 512), "RGB"),
    ((370, 1226), (256, 512), "RGB"),
    ((370, 1226), (256, 512), "L"),
    ((60, 200), (32, 64), "RGB"),
    ((60, 200), (96, 160), "RGB"),  # an upscale of the cropped columns
    ((370, 1226), (400, 1300), "L"),  # an upscale of both axes
])
@pytest.mark.parametrize("content", ["random", "smooth"])
def test_crop_resize_equals_pil(native, target, kind, content):
    img = _image(kind, content, *native, seed=4)
    box, _ = compute_crop_and_intrinsics(P2, native, target)
    got = crop_resize_bilinear(img, box, target)
    assert got.dtype == np.uint8 and got.shape == (target + ((3,) if kind == "RGB" else ()))
    np.testing.assert_array_equal(got, _pil_crop_resize(img, box, target))


def test_crop_resize_checks_its_box():
    img = _image("L", "random", 10, 20)
    np.testing.assert_array_equal(crop_resize_bilinear(img, (2, 1, 12, 6), (5, 10)),
                                  img[1:6, 2:12])
    with pytest.raises(ValueError, match="not inside"):
        crop_resize_bilinear(img, (-1, 0, 10, 10), (5, 5))
    with pytest.raises(ValueError, match="uint8"):
        crop_resize_bilinear(img.astype(np.float32), (0, 0, 10, 10), (5, 5))
