"""The port's RobotCar reader against the JAX package's (PIL and cv2) on the
same tree (``tests/torch_trees.py``: random Bayer PNGs at 96x128, a
distortion LUT that samples each pixel ~0.3 px off, a VO trajectory, an
axis-swapping camera extrinsic, and LiDAR scans of the plane with two
returns on some pixels).

``demosaic_gb2rgb`` equals cv2's ``COLOR_BayerGB2RGB`` byte for byte on
random samples at even and odd sizes. ``CameraModel.undistort``,
``load_image``, the pose interpolation and every key of the reader's
samples are ``np.array_equal`` to the JAX package's, for the JAX test's
cutout, the shipped configs' (scale 0.5, ``[0, 1/3, 0, 0]``) and the
reader's defaults.
"""

from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from monorec_tpu.data import pose_interp as j_pose_interp
from monorec_tpu.data import robotcar as j_robotcar
from monorec_tpu_torch.data import pose_interp, robotcar
from monorec_tpu_torch.data.bayer import demosaic_gb2rgb
from tests import torch_trees


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return torch_trees.write_robotcar(tmp_path_factory.mktemp("robotcar"))


@pytest.mark.parametrize("size", [(3, 3), (4, 5), (6, 8), (7, 9), (33, 47), (64, 96)])
def test_demosaic_matches_cv2(size):
    import cv2

    rng = np.random.default_rng(size[0] * 100 + size[1])
    for _ in range(4):
        raw = rng.integers(0, 256, size, dtype=np.uint8)
        np.testing.assert_array_equal(demosaic_gb2rgb(raw),
                                      cv2.cvtColor(raw, cv2.COLOR_BayerGB2RGB))


@pytest.mark.parametrize("raw", [np.zeros((2, 8), np.uint8), np.zeros((8, 8), np.uint16),
                                 np.zeros((8, 8, 3), np.uint8)])
def test_demosaic_rejects_what_it_does_not_take(raw):
    with pytest.raises(ValueError):
        demosaic_gb2rgb(raw)


def test_camera_model_and_load_image_match_jax(tree):
    folder = tree["sequence_folders"][0]
    port = robotcar.CameraModel(tree["model_folder"], folder)
    ref = j_robotcar.CameraModel(tree["model_folder"], folder)
    assert port.camera == ref.camera == "stereo_narrow_left"
    assert (port.focal_length, port.principal_point) == (ref.focal_length, ref.principal_point)
    rng = np.random.default_rng(0)
    for shape in (torch_trees.ROBOTCAR_RAW, (*torch_trees.ROBOTCAR_RAW, 3)):
        img = rng.uniform(0, 255, shape)
        np.testing.assert_array_equal(port.undistort(img), ref.undistort(img))
    assert not np.array_equal(port.undistort(img), img)  # the LUT moves pixels
    for path in sorted(Path(folder).glob("*.png"))[:3]:
        for p_model, j_model in ((port, ref), (None, None)):
            got, want = robotcar.load_image(path, p_model), j_robotcar.load_image(path, j_model)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)


def test_pose_interpolation_matches_jax(tree, tmp_path):
    rng = np.random.default_rng(1)
    for _ in range(5):
        x = rng.normal(size=6)
        np.testing.assert_array_equal(pose_interp.se3_from_xyzrpy(x),
                                      j_pose_interp.se3_from_xyzrpy(x))
    times = np.sort(rng.uniform(0, 10, 12))
    poses = [j_pose_interp.se3_from_xyzrpy(rng.normal(size=6)) for _ in times]
    query = rng.uniform(-1, 11, 20)  # inside and outside the trajectory
    for got, want in zip(pose_interp.interpolate_poses(times, poses, query, times[3]),
                         j_pose_interp.interpolate_poses(times, poses, query, times[3])):
        np.testing.assert_array_equal(got, want)
    # The tree's forward motion, and a vo.csv that turns and climbs.
    lines = ["source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw"]
    ts = 1_000_000 + 50_000 * np.arange(15)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        lines.append(f"{t1},{t0}," + ",".join(f"{v:.6f}" for v in rng.normal(0, 0.2, 6)))
    (tmp_path / "vo.csv").write_text("\n".join(lines) + "\n")
    for vo, q in ((tree["pose_files"][0], None), (tmp_path / "vo.csv", ts + 12_345)):
        q = q if q is not None else [int(p.stem) for p in sorted(Path(
            tree["sequence_folders"][0]).glob("*.png"))]
        for got, want in zip(pose_interp.interpolate_vo_poses(vo, q, min(q)),
                             j_pose_interp.interpolate_vo_poses(vo, q, min(q))):
            np.testing.assert_array_equal(got, want)


READER_CASES = {
    "jax_test": dict(scale=0.5, cutout=(0, 0, 0, 0), lidar_timestamp_range=0.05),
    "shipped_oxrc": dict(scale=0.5, cutout=(0, 0.333333333333333, 0, 0),
                         lidar_timestamp_range=0.25),
    "defaults": {},
    "frames4": dict(frame_count=4, scale=0.5, cutout=(0.1, 0, 0.2, 0.05)),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_jax(tree, case):
    args = dict(tree, **READER_CASES[case])
    port, ref = robotcar.OxfordRobotCarDataset(**args), j_robotcar.OxfordRobotCarDataset(**args)
    assert len(port) == len(ref) > 0
    for index in sorted({0, len(ref) // 2, len(ref) - 1}):
        got, want = port[index], ref[index]
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert (got["target"] > 0).sum() > 10


def test_window_quirks_kept(tree):
    """As in the JAX reader: an odd ``frame_count`` takes one frame more
    before the keyframe than it names (3 -> 4 frames; the first sample's
    earliest wraps to the sequence's last image), and the length does not
    count the dilation, so the last samples of a dilated window run past the
    sequence. No shipped config sets either."""
    for args, index in ((dict(frame_count=3), 0), (dict(dilation=2), -1)):
        port = robotcar.OxfordRobotCarDataset(**tree, **args)
        ref = j_robotcar.OxfordRobotCarDataset(**tree, **args)
        if index == 0:
            assert port[0]["frames"].shape[0] == ref[0]["frames"].shape[0] == 4
        else:
            for ds in (port, ref):
                with pytest.raises(IndexError):
                    ds[len(ds) - 1]


def test_two_returns_land_on_one_pixel(tree, monkeypatch):
    """The tree's scans put two returns on some pixels of every keyframe, so
    the order of the sort decides which one the target keeps."""
    projected = []
    project = robotcar.CameraModel.project

    def recording(self, points, image_size):
        uv, d = project(self, points, image_size)
        projected.append(uv)
        return uv, d

    monkeypatch.setattr(robotcar.CameraModel, "project", recording)
    ds = robotcar.OxfordRobotCarDataset(**tree, **READER_CASES["shipped_oxrc"])
    for index in range(len(ds)):
        ds[index]
        pixels = (projected[-1] * 0.5).astype(np.int64)
        _, counts = np.unique(pixels, axis=1, return_counts=True)
        assert counts.max() >= 2, index


def test_shipped_cutout_keeps_one_row_too_many(tree):
    """The shipped oxrc configs' cutout 0.333333333333333 truncates the rows
    it removes: at RobotCar's native 960x1280 and scale 0.5 it keeps 321 of
    480 rows, where 1/3 keeps 320. Both packages' readers do so (here at
    96x128: 33 of 48 rows), and neither package's model takes an image
    whose height is not a multiple of 32 (ROADMAP Queue 3)."""
    import torch

    from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from monorec_tpu_torch.models import MonoRec, MonoRecConfig

    assert 480 - int(480 * 0.333333333333333) == 321 and 480 - int(480 / 3) == 320
    args = dict(tree, **READER_CASES["shipped_oxrc"])
    got = robotcar.OxfordRobotCarDataset(**args)[0]
    want = j_robotcar.OxfordRobotCarDataset(**args)[0]
    assert got["keyframe"].shape == want["keyframe"].shape == (33, 64, 3)
    args["cutout"] = chip_smoke.ROBOTCAR_CUTOUT  # 1/3 to the double's last digit
    assert robotcar.OxfordRobotCarDataset(**args)[0]["keyframe"].shape == (32, 64, 3)
    model = MonoRec(MonoRecConfig(cv_depth_steps=4), "cpu")
    model.eval()
    with pytest.raises(RuntimeError), torch.no_grad():
        model(batch_to_torch(make_batch(1, 33, 64, 2, stereo=False, mask=False), "cpu"))
