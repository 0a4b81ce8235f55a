"""The rest of the port's ``utils`` against the JAX package's
(``monorec_tpu/utils/core.py``) on the same seeded numpy inputs, and the
TSDF export's writers against PIL, which the JAX package saves with:

* ``masked_where``, ``Timer``, ``pose_distance_thresh`` (poses at and
  around both thresholds) and ``dilate_mask`` (odd and even sizes, odd
  shapes) are exactly equal;
* ``encode_jpeg`` writes the bytes of ``Image.fromarray(rgb).save`` (PIL
  12.1, libjpeg-turbo 3.1.3) for random and smooth images at sizes that are
  and are not multiples of 8 and 16, and for the pinned image whose digest
  ``chip_smoke.py`` checks on the card; its rounding division equals
  libjpeg-turbo's reciprocal multiply for every 8-bit table entry;
* ``write_png``'s 16-bit greyscale file decodes equal to Pillow's mode-"I"
  file, and its 8-bit files are the bytes the 8-bit-only writer wrote;
* ``save_frame_for_tsdf`` / ``save_intrinsics_for_tsdf`` write the JAX
  functions' four files: the JPEG and both text files byte-equal, the
  depth PNG pixel-equal, with the clip at 65535, NaN, negative and zero
  inverse depths, and depths past the int32 range (written as 0).
"""

import hashlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import monorec_tpu.utils as jax_utils
import monorec_tpu_torch.utils as port_utils
from monorec_tpu.utils import core as jax_core
from monorec_tpu_torch.data.jpeg_encoder import encode_jpeg, write_jpeg
from monorec_tpu_torch.data.png import read_png, write_png
from monorec_tpu_torch.utils import core as port_core


def test_exports_every_name_of_the_jax_package():
    assert set(port_utils.__all__) == set(jax_utils.__all__)


def test_masked_where():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(2, 3, 5, 7)).astype(np.float32)
    invalid = rng.random((2, 1, 5, 7)) < 0.4
    for fill in (0.0, -1.5):
        want = np.asarray(jax_utils.masked_where(jnp.asarray(invalid), jnp.asarray(t), fill))
        got = port_utils.masked_where(torch.from_numpy(invalid), torch.from_numpy(t), fill)
        np.testing.assert_array_equal(got.numpy(), want)


def test_timer(monkeypatch):
    got = []
    for mod in (jax_core, port_core):
        clock = iter([10.0, 10.25, 11.0, 12.5, 13.0])
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
        timer = mod.Timer()
        got.append((timer.check(), timer.check(), timer.reset(), timer.check()))
    assert got[0] == got[1] == (0.25, 0.75, None, 0.5)


def _poses(seed: int, b: int = 24, f: int = 3):
    """Keyframe and frame poses whose spreads sit at, just under and just
    over both thresholds, and far from them."""
    rng = np.random.default_rng(seed)
    key = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    frames = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    scales = np.array([1.0, 1 - 1e-7, 1 + 1e-7, 0.5, 2.0, 0.0], np.float32)
    for i in range(b):
        which = i % 2  # the spatial or the rotational spread near its threshold
        s = scales[(i // 2) % len(scales)]
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        if which == 0:
            frames[i, rng.integers(f), :3, 3] = 0.6 * s * direction
        else:
            angle = 0.05 * s  # a small rotation about y moves the forward column
            c, n = np.cos(angle), np.sin(angle)
            frames[i, rng.integers(f), :3, :3] = [[c, 0, n], [0, 1, 0], [-n, 0, c]]
        key[i, :3, 3] = rng.normal(size=3) * 1e-3 * (i % 3 == 0)
    return key, frames


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_distance_thresh(seed):
    key, frames = _poses(seed)
    for spatial, rotational in ((0.6, 0.05), (0.3, 0.1)):
        want = np.asarray(jax_utils.pose_distance_thresh(jnp.asarray(key), jnp.asarray(frames),
                                                         spatial, rotational))
        got = port_utils.pose_distance_thresh(torch.from_numpy(key), torch.from_numpy(frames),
                                              spatial, rotational)
        assert got.dtype == torch.bool and got.shape == (len(key),)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("size", [1, 3, 4, 15])
@pytest.mark.parametrize("shape", [(2, 1, 17, 23), (1, 2, 9, 30)])
def test_dilate_mask(size, shape):
    rng = np.random.default_rng(size)
    mask = rng.random(shape).astype(np.float32) ** 6  # sparse hits over 0.5
    mask[0, 0, 0, -1] = mask[-1, -1, -1, 0] = 0.5  # at the threshold, at the corners
    want = np.asarray(jax_utils.dilate_mask(jnp.asarray(mask.transpose(0, 2, 3, 1)), size))
    got = port_utils.dilate_mask(torch.from_numpy(mask), size)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))


def _pil_jpeg(rgb) -> bytes:
    import io

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG")
    return buf.getvalue()


def _rgb(h: int, w: int, seed: int, smooth: bool):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    v, u = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(u / (7.0 + c) + c) * np.cos(v / (5.0 + c))
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h, w", [(37, 53), (35, 48), (256, 512), (1, 1), (9, 7), (16, 16),
                                  (17, 33), (24, 40)])
@pytest.mark.parametrize("smooth", [False, True])
def test_encode_jpeg_is_pils_bytes(h, w, smooth):
    for seed in (0, 1):
        rgb = _rgb(h, w, seed, smooth)
        assert encode_jpeg(rgb) == _pil_jpeg(rgb)


def test_pinned_jpeg_digest(tmp_path):
    """The digest ``chip_smoke.py`` phase 31 checks on a machine without PIL
    is that of PIL's file."""
    rgb = chip_smoke.tsdf_pinned_rgb()
    assert rgb.shape == (256, 512, 3) and rgb.dtype == np.uint8
    assert hashlib.sha256(_pil_jpeg(rgb)).hexdigest() == chip_smoke.TSDF_JPEG_SHA256
    write_jpeg(tmp_path / "a.jpg", rgb)
    assert hashlib.sha256((tmp_path / "a.jpg").read_bytes()).hexdigest() == (
        chip_smoke.TSDF_JPEG_SHA256)


def test_encode_jpeg_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            encode_jpeg(bad)


def _reciprocal(divisor: int):
    """``jcdctmgr.c::compute_reciprocal`` with 16-bit DCTELEMs (libjpeg-turbo
    built with SIMD): (reciprocal, correction, shift in bits)."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def test_rounding_division_is_libjpeg_turbos_reciprocal():
    """The quantizer divides by 8 x each table entry rounding half away from
    zero; libjpeg-turbo multiplies |x| + correction by a reciprocal and
    shifts. The two agree for every 8-bit entry over |x| < 2^15, the whole
    range of the 16-bit DCT outputs."""
    x = np.arange(1 << 15, dtype=np.int64)
    for q in range(1, 256):
        d = 8 * q
        fq, c, r = _reciprocal(d)
        np.testing.assert_array_equal((x + c) * fq >> r, (x + d // 2) // d, err_msg=str(q))


# The digests of the 8-bit files the writer wrote before it took 16 bits.
PNG_8BIT_SHA256 = {
    (5, 7): "afb7f1b9cd2f90ae5536a5bd9e6cce3bf56d8a7cfdb440b65ffdda777fc9eb77",
    (6, 9, 3): "d78798c29efa9abd17032dceb95d10de9352cf9c545fba8e98f5a46de8e38e6b",
    (1, 1): "e5f9fa643d4a53026aafa75a6e6928411c64a6451d94000d990a6fb88808a6f0",
    (37, 53, 3): "6b5a7d1c1e69e2630d49385455a037680a7f65424427d9c3d1093df6665ea115",
}


@pytest.mark.parametrize("shape", list(PNG_8BIT_SHA256))
def test_write_png_8bit_bytes_unchanged(tmp_path, shape):
    a = np.random.default_rng(len(shape) + shape[0]).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "a.png", a)
    assert hashlib.sha256((tmp_path / "a.png").read_bytes()).hexdigest() == PNG_8BIT_SHA256[shape]


@pytest.mark.parametrize("shape", [(1, 1), (13, 29), (64, 96)])
def test_write_png_16bit_equals_pillows_mode_i(tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    depth = rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    depth.reshape(-1)[: depth.size // 2] //= 2**16  # half inside [0, 65535] or just below
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(depth, mode="I").save(tmp_path / "pil.png")
    write_png(tmp_path / "port.png", np.clip(depth, 0, 65535).astype(np.uint16))
    pil = np.asarray(Image.open(tmp_path / "pil.png"))
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"), pil)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), pil)
    assert read_png(tmp_path / "port.png").dtype == np.uint16


TSDF_H, TSDF_W = 37, 45
TSDF_CROP = [3, 34, 5, 41]


def _tsdf_inputs(seed: int):
    rng = np.random.default_rng(seed)
    keyframe = (rng.random((3, TSDF_H, TSDF_W)) - 0.5).astype(np.float32)
    keyframe[:, 0, :4] = [-0.7, -0.5, 0.5, 0.6]  # outside and at [-0.5, 0.5]
    inv = rng.uniform(0.0025, 0.5, (TSDF_H, TSDF_W)).astype(np.float32)
    special = np.array([0.0, -0.2, np.nan, 1e-4, 1e-8, 1e-40, np.inf, 0.02, 1 / 3, 1 / 80],
                       np.float32)
    inv[TSDF_H // 2, TSDF_W // 2 - 5 : TSDF_W // 2 + 5] = special  # inside the crop
    inv[-1, -10:] = special  # outside it
    angle = rng.uniform(-0.3, 0.3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                    [-np.sin(angle), 0, np.cos(angle)]]
    pose[:3, 3] = rng.normal(size=3) * 5
    k = np.array([[40.5, 0, 22.25, 0], [0, 41.0, 18.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    return keyframe, inv, pose, k


@pytest.mark.parametrize("seed, crop, min_distance, max_distance", [
    (0, None, None, None), (1, TSDF_CROP, None, None), (2, None, 3.0, None),
    (3, TSDF_CROP, 3.0, 80.0)])
def test_save_frame_for_tsdf_writes_the_jax_files(tmp_path, seed, crop, min_distance,
                                                  max_distance):
    keyframe, inv, pose, k = _tsdf_inputs(seed)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    with warnings.catch_warnings():  # Pillow 12 deprecates saving mode "I"; numpy's casts
        warnings.simplefilter("ignore", DeprecationWarning)
        warnings.simplefilter("ignore", RuntimeWarning)
        jax_utils.save_frame_for_tsdf(jax_dir, 7, keyframe.transpose(1, 2, 0), inv, pose,
                                      crop, min_distance, max_distance)
    jax_utils.save_intrinsics_for_tsdf(jax_dir, k, crop)
    port_utils.save_frame_for_tsdf(port_dir, 7, torch.from_numpy(keyframe),
                                   torch.from_numpy(inv[None]), torch.from_numpy(pose),
                                   crop, min_distance, max_distance)
    port_utils.save_intrinsics_for_tsdf(port_dir, torch.from_numpy(k), crop)

    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir()) == [
        "camera-intrinsics.txt", "frame-000007.color.jpg", "frame-000007.depth.png",
        "frame-000007.pose.txt"]
    for name in ("frame-000007.color.jpg", "frame-000007.pose.txt", "camera-intrinsics.txt"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    want = np.asarray(Image.open(jax_dir / "frame-000007.depth.png"))
    got = read_png(port_dir / "frame-000007.depth.png")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint16
    # The special values reached the file as the host cast gives them.
    row = got[(TSDF_H // 2 - crop[0]) if crop else TSDF_H // 2]
    col = TSDF_W // 2 - 5 - (crop[2] if crop else 0)
    values = row[col : col + 10]
    assert values[0] == values[1] == values[2] == 0  # 0, negative, NaN
    assert values[3] == (0 if max_distance else 65535)  # 1e6 cm, clipped
    assert values[4] == values[5] == values[6] == 0  # INT_MIN, INT_MIN, 0 cm
    assert values[7] == 5000 and values[8] == 300


def test_save_frame_for_tsdf_takes_an_hw_inverse_depth(tmp_path):
    keyframe, inv, pose, _ = _tsdf_inputs(5)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    port_utils.save_frame_for_tsdf(tmp_path / "a", 0, keyframe, inv[None], pose)
    port_utils.save_frame_for_tsdf(tmp_path / "b", 0, torch.from_numpy(keyframe),
                                   torch.from_numpy(inv), torch.from_numpy(pose))
    for name in ("frame-000000.color.jpg", "frame-000000.depth.png", "frame-000000.pose.txt"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
