"""The port's KITTI reader against the JAX package's on the same tree
(``tests/torch_kitti.py``: 60x200 PNGs written with PIL, read at 32x64), and
the sample cache in both directions.

Every key of every sample is ``np.array_equal`` to the JAX reader's for the
data arguments of the shipped configs (the target size cut to 32x64, the
sequences to the tree's). Where colour augmentation is on, the images go
through the jitter's float arithmetic in both packages: they are held at
atol 1e-6, every other key exactly. Every shipped KITTI config also builds
its loader on the tree.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monorec_tpu.data.cache import CachedDataset as JCachedDataset
from monorec_tpu.data.cache import build_cache as j_build_cache
from monorec_tpu.data.kitti import KittiOdometryDataset as JKitti
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.data.cache import CachedDataset, build_cache
from monorec_tpu_torch.data.kitti import KittiOdometryDataset, load_calib
from monorec_tpu_torch.data.loader import DatasetWrapper
from monorec_tpu_torch.tools import build_cache as build_cache_tool
from tests import torch_kitti

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
IMAGE_KEYS = ("keyframe", "frames", "stereoframe")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return torch_kitti.write_tree(tmp_path_factory.mktemp("kitti"))


def _args(config: str, key: str = "data_loader", **extra):
    with open(CONFIGS / config) as f:
        block = json.load(f)[key]
    args = {k: v for k, v in block["args"].items() if k not in config_mod._LOADER_KEYS}
    args.update(target_image_size=list(torch_kitti.TARGET),
                sequences=list(torch_kitti.SEQUENCES), **extra)
    return args


def _assert_samples_equal(port, ref, jitter: bool):
    assert set(port) == set(ref)
    for key, want in ref.items():
        got = port[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if jitter and key in IMAGE_KEYS:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


READER_CASES = {
    "eval_monorec": ("evaluate/eval_monorec.json", {}),
    "monorec_depth": ("train/monorec/monorec_depth.json", {}),
    "monorec_depth_no_jitter": ("train/monorec/monorec_depth.json",
                                {"use_color_augmentation": False}),
    "monorec_mask": ("train/monorec/monorec_mask.json", {}),
    "monorec_mask_ref": ("train/monorec/monorec_mask_ref.json",
                         {"use_color_augmentation": False}),
    "val_jitter_seed3": ("train/monorec/monorec_depth.json", {"seed": 3},),
    "lidar_npz_dilation": ("evaluate/eval_monorec.json",
                           {"annotated_lidar": False, "depth_folder": "image_depth_npz",
                            "dilation": 2, "offset_d": 1, "frame_count": 3, "max_length": 5}),
    "dense_npy_grey": ("evaluate/eval_monorec.json",
                       {"lidar_depth": False, "depth_folder": "image_depth_npy",
                        "use_color": False, "custom_length": 3, "use_dso_poses": False}),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_jax(tree, case):
    config, extra = READER_CASES[case]
    args = _args(config, dataset_dir=str(tree), **extra)
    if case == "val_jitter_seed3":
        args = _args(config, "val_data_loader", dataset_dir=str(tree), **extra)
    if not args.get("use_color", True):  # the greyscale cameras: copies of the colour ones
        for seq in torch_kitti.SEQUENCES:
            for cam, grey in (("image_2", "image_0"), ("image_3", "image_1")):
                (tree / "sequences" / seq / grey).mkdir(exist_ok=True)
                for p in (tree / "sequences" / seq / cam).glob("*.png"):
                    torch_kitti.pil_write(tree / "sequences" / seq / grey / p.name,
                                          np.asarray(torch_kitti.Image.open(p).convert("L")))
    port, ref = KittiOdometryDataset(**args), JKitti(**args)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        _assert_samples_equal(port[i], ref[i], args.get("use_color_augmentation", False))


def test_calib_parses_like_numpy_fromstring(tree):
    text = (tree / "sequences" / "07" / "calib.txt").read_text()
    calib = load_calib(tree / "sequences" / "07" / "calib.txt")
    assert sorted(calib) == ["P0", "P1", "P2", "P3"]
    for line in text.splitlines():
        key, vals = line.split(":", 1)
        ref = np.array([float(v) for v in vals.split()]).reshape(3, 4)
        np.testing.assert_array_equal(calib[key], ref)


@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_cache_reads_in_both_packages(tree, tmp_path, built_by):
    args = _args("train/monorec/monorec_depth.json", dataset_dir=str(tree),
                 use_color_augmentation=False, max_length=3)
    dataset = (JKitti if built_by == "jax" else KittiOdometryDataset)(**args)
    (j_build_cache if built_by == "jax" else build_cache)(dataset, tmp_path / "c", log_every=0)
    for jitter in (False, True):
        port = CachedDataset(str(tmp_path / "c"), color_augmentation=jitter, seed=5)
        ref = JCachedDataset(str(tmp_path / "c"), color_augmentation=jitter, seed=5)
        assert len(port) == len(ref) == len(dataset)
        for i in range(len(ref)):
            _assert_samples_equal(port[i], ref[i], jitter)
    # The cached images are the reader's within half a level of 8 bits.
    sample, cached = dataset[1], CachedDataset(str(tmp_path / "c"))[1]
    for key in IMAGE_KEYS:
        np.testing.assert_allclose(cached[key], sample[key], rtol=0, atol=0.5 / 255 + 1e-6)


def test_build_cache_tool_and_cached_loader(tree, tmp_path):
    config = json.loads((CONFIGS / "train/monorec/monorec_depth.json").read_text())
    config["data_loader"]["args"].update(_args("train/monorec/monorec_depth.json",
                                               dataset_dir=str(tree), max_length=2))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    assert build_cache_tool.main(["-c", str(path), "--out", str(tmp_path / "c")]) == 0
    loader = config_mod.build_data_loader(
        {"type": "CachedDataloader",
         "args": {"cache_dir": str(tmp_path / "c"), "batch_size": 2, "shuffle": False}}, "cpu")
    batch = next(iter(loader))
    assert batch["keyframe"].shape == (2, 3) + torch_kitti.TARGET
    assert batch["stereoframe"].shape == (2, 3) + torch_kitti.TARGET
    assert len(loader) == 2  # 2 samples per sequence


SHIPPED_KITTI = [
    ("evaluate/eval_monorec.json", "data_loader"),
    ("evaluate/eval_monorec_fixture.json", "data_loader"),
    ("evaluate/eval_monorec_fixture_trained.json", "data_loader"),
    ("smoke/train_fixture_overfit.json", "data_loader"),
    ("train/monorec/monorec_depth.json", "data_loader"),
    ("train/monorec/monorec_depth.json", "val_data_loader"),
    ("train/monorec/monorec_depth_ref.json", "data_loader"),
    ("train/monorec/monorec_mask.json", "data_loader"),
    ("train/monorec/monorec_mask_ref.json", "data_loader"),
    ("test/pointcloud_monorec.json", "data_set"),
]


@pytest.mark.parametrize("config,key", SHIPPED_KITTI)
def test_every_shipped_kitti_config_builds_its_loader(tree, config, key):
    block = json.loads((CONFIGS / config).read_text())[key]
    args = dict(block["args"], dataset_dir=str(tree), target_image_size=list(torch_kitti.TARGET),
                sequences=["07"], batch_size=min(block["args"].get("batch_size", 1), 2))
    if "start" in args:  # the seq-07 fixture's one keyframe: here the tree's first
        args.update(start=0, end=1, custom_length=None)
    if key == "data_set":
        dataset = config_mod.build_dataset(block["type"], args)
        assert len(dataset) == 16 - 10
        return
    loader = config_mod.build_data_loader({"type": block["type"], "args": args}, "cpu")
    if "start" in args:
        assert isinstance(loader.dataset, DatasetWrapper) and len(loader.dataset) == 1
    batch = next(iter(loader))
    assert batch["keyframe"].shape[1:] == (3,) + torch_kitti.TARGET
    assert batch["keyframe"].dtype == torch.float32 and torch.isfinite(batch["target"]).all()
    assert ("stereoframe" in batch) == bool(args.get("return_stereo"))


def test_other_readers_name_their_roadmap_item():
    """The RobotCar and TUM readers (ROADMAP item 17b) are ported: their
    names reach the readers' constructors (which want their folders); a
    data set the port does not know still raises, naming it."""
    for kind in ("TUMMonoVODataset", "TUMRGBDDataloader", "OxfordRobotCarDataloader"):
        with pytest.raises(TypeError, match="required positional argument"):
            config_mod.build_dataset(kind, {})
    with pytest.raises(NotImplementedError, match="NuScenesDataset"):
        config_mod.build_dataset("NuScenesDataset", {})
