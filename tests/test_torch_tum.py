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
* The depth EXRs, which the JAX reader reads with cv2 and the port cannot:
  the port raises where a frame's EXR exists, and for ``only_keyframes``
  over EXRs.
"""

import numpy as np
import pytest

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


def test_exr_depth_raises_where_jax_reads_one(mono, tmp_path):
    import shutil

    root = tmp_path / "seq"
    shutil.copytree(mono, root)
    args = dict(target_image_size=torch_trees.TARGET, color_augmentation=False)
    (root / "images_depth").mkdir()
    (root / "images_depth" / "00003_d.exr").write_bytes(b"v/1\x01 not read here")
    port, ref = TUMMonoVODataset(str(root), **args), JMonoVO(str(root), **args)
    # Sample 0's keyframe is frame 1: no EXR, zeros in both.
    np.testing.assert_array_equal(port[0]["target"], ref[0]["target"])
    assert not port[0]["target"].any()
    ref[2]  # the JAX reader reads frame 3's EXR with cv2
    with pytest.raises(NotImplementedError, match="EXR"):
        port[2]
    with pytest.raises(NotImplementedError, match="EXR"):
        TUMMonoVODataset(str(root), only_keyframes=True, **args)
    # No EXRs at all: only_keyframes selects nothing, in both.
    assert len(TUMMonoVODataset(str(mono), only_keyframes=True, **args)) == len(
        JMonoVO(str(mono), only_keyframes=True, **args)) == 0
