"""The port's TUM readers against the JAX package's (PIL) on the same trees
(``tests/torch_trees.py``): every key of every sample ``np.array_equal``,
the colour-jittered images within atol 1e-6 (the jitter's float arithmetic,
as ``tests/test_torch_kitti.py`` holds it).

* TUM RGB-D: RGB and 16-bit depth PNGs on their own clocks (the nearest
  depth image per RGB image), a ground-truth trajectory at a third rate
  with turning quaternions (interpolated at the RGB timestamps).
* TUM mono VO: greyscale JPEGs written by PIL at 60x80 (every third with
  restart markers), read at 32x64, ``camera.txt`` with a model name before
  the intrinsics; with and without the jitter, several windows, the
  shipped export config's arguments, and the multi-directory wrapper.
* The depth EXRs (``chip_smoke.encode_exr``: every compression, pixel type
  and line order the port reads, a three-channel file, a data window off
  the origin), which the JAX reader reads with cv2: a cv2 built without
  OpenEXR returns None for them, so the tests stub ``cv2.imread`` to return
  the written arrays, and hold the port's decode, crop, 2x2 max or float
  resize, clamp and ``only_keyframes`` index to the JAX reader's.
* A colour tree (PIL's JPEGs at 4:4:4, 4:2:2 and 4:2:0) with depth files,
  and one whose frames are by turns progressive, CMYK (which both readers
  convert to RGB before they resize), progressive CMYK and progressive
  with restart markers (``torch_trees.pil_progressive_cmyk``).
"""

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from monorec_tpu.data.tum_mono_vo import TUMMonoVODataset as JMonoVO
from monorec_tpu.data.tum_mono_vo import TUMMonoVOMultiDataset as JMonoVOMulti
from monorec_tpu.data.tum_rgbd import TUMRGBDDataset as JRGBD
from monorec_tpu_torch.data.tum_mono_vo import TUMMonoVODataset, TUMMonoVOMultiDataset
from monorec_tpu_torch.data.tum_rgbd import TUMRGBDDataset
from tests import torch_trees

IMAGE_KEYS = ("keyframe", "frames")


@pytest.fixture(scope="module")
def rgbd(tmp_path_factory):
    return torch_trees.write_tum_rgbd(tmp_path_factory.mktemp("rgbd"))


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    return torch_trees.write_tum_mono(tmp_path_factory.mktemp("mono"))


def _assert_samples_equal(port, ref, jitter: bool = False):
    assert len(port) == len(ref) > 0
    for index in range(len(ref)):
        got, want = port[index], ref[index]
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            if jitter and key in IMAGE_KEYS:
                np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("args", [{}, {"frame_count": 3}, {"dilation": 2}],
                         ids=["default", "frames3", "dilation2"])
def test_rgbd_reader_matches_jax(rgbd, args):
    _assert_samples_equal(TUMRGBDDataset(str(rgbd), **args), JRGBD(str(rgbd), **args))
    assert (TUMRGBDDataset(str(rgbd))[0]["target"] > 0).mean() > 0.5


_TMVO = torch_trees.shipped("test/pointcloud_monorec_tmvo.json")["data_set"]["args"]
MONO_CASES = {
    "shipped_tmvo": dict({k: v for k, v in _TMVO.items() if k != "dataset_dir"},
                         target_image_size=list(torch_trees.TARGET)),
    "jitter": dict(target_image_size=torch_trees.TARGET, color_augmentation=True, seed=3),
    "no_jitter_dilation2": dict(target_image_size=torch_trees.TARGET, color_augmentation=False,
                                dilation=2, max_length=2),
    "full_size": dict(target_image_size=(60, 80), color_augmentation=False),
}


@pytest.mark.parametrize("case", sorted(MONO_CASES))
def test_mono_vo_reader_matches_jax(mono, case):
    args = MONO_CASES[case]
    _assert_samples_equal(TUMMonoVODataset(str(mono), **args), JMonoVO(str(mono), **args),
                          jitter=args.get("color_augmentation", True))


def test_mono_vo_multi_matches_jax(mono):
    args = dict(target_image_size=torch_trees.TARGET, color_augmentation=False, frame_count=2)
    port = TUMMonoVOMultiDataset([str(mono), str(mono)], **args)
    _assert_samples_equal(port, JMonoVOMulti([str(mono), str(mono)], **args))
    np.testing.assert_array_equal(port[len(port) // 2 + 1]["keyframe"], port[1]["keyframe"])


# The depth files of the EXR trees: every other frame, in each compression,
# pixel type and line order the reader takes; frame 2's holds R, G and B
# (the reader takes cv2's channel 0, B) in a data window off the origin.
DEPTH = {0: {"compression": "ZIP"}, 2: {"compression": "ZIP", "origin": (5, -3)},
         4: {"compression": "RLE", "pixel_type": "HALF"},
         6: {"compression": "ZIPS", "line_order": "DECREASING_Y"}, 8: {"compression": "NONE"}}


def _write_depth_tree(root, colour: bool, write=torch_trees.pil_jpeg):
    """A TUM tree with DEPTH's files, and what cv2 returns for each file."""
    torch_trees.write_tum_mono(root, colour=colour, depth=DEPTH, write=write)
    written = {}
    for i, options in DEPTH.items():
        path = root / "images_depth" / f"{i:05d}_d.exr"
        d = chip_smoke.tum_depth(torch_trees.TUM_RAW, i)
        if i == 2:
            path.write_bytes(chip_smoke.encode_exr({"R": 2 * d, "G": 3 * d, "B": d}, **options))
            d = np.stack([d, 3 * d, 2 * d], axis=-1)
        if options.get("pixel_type") == "HALF":
            d = d.astype(np.float16).astype(np.float32)
        written[str(path)] = d
    return root, written


@pytest.fixture(scope="module")
def depth_tree(tmp_path_factory):
    return _write_depth_tree(tmp_path_factory.mktemp("depth"), colour=False)


@pytest.fixture(scope="module")
def colour_tree(tmp_path_factory):
    return _write_depth_tree(tmp_path_factory.mktemp("colour"), colour=True)


def _stub_cv2(monkeypatch, written):
    """cv2.imread returns the written arrays, as a cv2 built with OpenEXR
    does (one built without it returns None, and the JAX reader zeros)."""
    import cv2

    def imread(path, flags):
        assert flags == cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
        return written[str(path)].copy()

    monkeypatch.setattr(cv2, "imread", imread)


# The 60x80 frames crop to 40x80: a target of 20x40 takes the 2x2 max, one
# of 32x64 Pillow's float resize.
DEPTH_CASES = {
    "resize": dict(target_image_size=torch_trees.TARGET),
    "max_pool": dict(target_image_size=(20, 40)),
    "keyframes_resize": dict(target_image_size=torch_trees.TARGET, only_keyframes=True),
    "keyframes_max_pool_f4": dict(target_image_size=(20, 40), only_keyframes=True,
                                  frame_count=4),
    "keyframes_dilation2": dict(target_image_size=torch_trees.TARGET, only_keyframes=True,
                                dilation=2),
}


@pytest.mark.parametrize("case", sorted(DEPTH_CASES))
def test_exr_depth_matches_jax(depth_tree, case, monkeypatch):
    root, written = depth_tree
    _stub_cv2(monkeypatch, written)
    args = dict(DEPTH_CASES[case], color_augmentation=False)
    port, ref = TUMMonoVODataset(str(root), **args), JMonoVO(str(root), **args)
    if args.get("only_keyframes"):
        np.testing.assert_array_equal(port._keyframe_index, ref._keyframe_index)
    _assert_samples_equal(port, ref)
    targets = np.stack([port[i]["target"] for i in range(len(port))])
    assert (targets > 0).any() and (targets == 0).any()  # depth, and its holes


COLOUR_CASES = {
    "shipped_tmvo": MONO_CASES["shipped_tmvo"],
    "jitter_keyframes": dict(target_image_size=torch_trees.TARGET, color_augmentation=True,
                             seed=5, only_keyframes=True),
}


@pytest.mark.parametrize("case", sorted(COLOUR_CASES))
def test_mono_vo_colour_matches_jax(colour_tree, case, monkeypatch):
    """Colour JPEGs written by PIL (4:4:4, 4:2:2, 4:2:0, some with restart
    markers), which the JAX reader decodes with PIL, with the depth files."""
    root, written = colour_tree
    _stub_cv2(monkeypatch, written)
    args = COLOUR_CASES[case]
    port, ref = TUMMonoVODataset(str(root), **args), JMonoVO(str(root), **args)
    _assert_samples_equal(port, ref, jitter=args.get("color_augmentation", True))
    frames = port[0]["frames"]
    assert not np.array_equal(frames[..., 0], frames[..., 1])  # colour, not grey


@pytest.fixture(scope="module")
def progressive_cmyk_tree(tmp_path_factory):
    return _write_depth_tree(tmp_path_factory.mktemp("progressive_cmyk"), colour=True,
                             write=torch_trees.pil_progressive_cmyk)


@pytest.mark.parametrize("case", sorted(COLOUR_CASES))
def test_mono_vo_progressive_cmyk_matches_jax(progressive_cmyk_tree, case, monkeypatch):
    """Progressive and CMYK JPEGs written by PIL, which the JAX reader
    decodes and converts to RGB with PIL."""
    root, written = progressive_cmyk_tree
    modes = {}
    for path in sorted((root / "images").glob("*.jpg")):
        with Image.open(path) as im:
            modes[im.mode, "progression" in im.info] = path
    assert set(modes) == {("RGB", True), ("CMYK", False), ("CMYK", True)}
    _stub_cv2(monkeypatch, written)
    args = COLOUR_CASES[case]
    port, ref = TUMMonoVODataset(str(root), **args), JMonoVO(str(root), **args)
    _assert_samples_equal(port, ref, jitter=args.get("color_augmentation", True))


def test_exr_depth_absent_and_no_keyframes(mono):
    """Without depth files the targets are zeros and only_keyframes selects
    nothing, in both readers."""
    args = dict(target_image_size=torch_trees.TARGET, color_augmentation=False)
    port, ref = TUMMonoVODataset(str(mono), **args), JMonoVO(str(mono), **args)
    np.testing.assert_array_equal(port[0]["target"], ref[0]["target"])
    assert not port[0]["target"].any()
    assert len(TUMMonoVODataset(str(mono), only_keyframes=True, **args)) == len(
        JMonoVO(str(mono), only_keyframes=True, **args)) == 0
