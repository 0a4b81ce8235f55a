"""The port's point-cloud export against the JAX package's.

* ``pointcloud_masks`` (the cv_mask >= .1 threshold and the 33x33 veto with
  its 16/17 pad) equals JAX's exactly.
* ``PLYWriter`` files are byte-equal on identical inputs, with an roi and
  dropout 0.75 (the same ``default_rng`` draws).
* ``export_pointcloud`` end to end on a KITTI-layout tree
  (``tests/torch_kitti.py``, 20 frames at 60x200 read at 32x64: 10 samples,
  the middle frames of 6 windows of 5) with carried
  weights (``tests/torch_carried.py``) and dropout 0: the same vertex count,
  coordinates within 1e-3 relative. A point whose depth lies within the
  forward's budget (rtol 1e-3 / atol 2e-4 on inverse depth) of ``min_d`` or
  ``max_d`` may fall on either side in either package: such points are
  counted and reported, and there are none at this seed.
* ``cli.create_pointcloud`` on a copy of the shipped
  ``pointcloud_monorec.json`` (dropout 0.75, the same draws in both) against
  the JAX CLI, with the mask on and off.

The carried init weights predict 45-400 m here, so ``max_d`` is raised to
1000 (the shipped 30 keeps no point; below 400 m, where the inverse depth
saturates, hundreds of pixels lie within the budget of the bound). Their
cv_mask is ~0.5 everywhere, so with the mask on both clouds are empty
(every pixel is vetoed).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from monorec_tpu.cli import create_pointcloud as j_create_pointcloud
from monorec_tpu.data import DataLoader as JDataLoader
from monorec_tpu.data.kitti import KittiOdometryDataset as JKitti
from monorec_tpu.export import PLYWriter as JPLYWriter
from monorec_tpu.export import export_pointcloud as j_export_pointcloud
from monorec_tpu.export import pointcloud_masks as j_pointcloud_masks
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch.cli import create_pointcloud
from monorec_tpu_torch.data.kitti import KittiOdometryDataset
from monorec_tpu_torch.data.loader import DataLoader
from monorec_tpu_torch.export import PLYWriter, export_pointcloud, pointcloud_masks
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train.checkpoints import load_stage_checkpoints
from tests import torch_carried, torch_kitti

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
RESULT_RTOL, RESULT_ATOL = 1e-3, 2e-4
MAX_D = 1000.0
MODEL_ARGS = dict(inv_depth_min_max=(0.33, 0.0025), pretrain_mode=0, use_stereo=False,
                  use_mono=True)



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the cores beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pc")
    tree = torch_kitti.write_tree(root / "kitti", 20, sequences=("07",))
    jax_ckpt, port_ckpt, variables = torch_carried.write_checkpoints(root, **MODEL_ARGS)
    return root, tree, jax_ckpt, port_ckpt, variables


def test_pointcloud_masks_match_jax():
    rng = np.random.default_rng(0)
    cv_mask = rng.uniform(0, 0.1, (2, 70, 90, 1)).astype(np.float32)
    for b, y, x in ((0, 3, 5), (0, 60, 80), (1, 35, 16), (1, 35, 17)):
        cv_mask[b, y, x, 0] = 0.1  # a hit exactly at the threshold
    cv_mask[1, 10, 60, 0] = np.nextafter(np.float32(0.1), np.float32(0))  # just below
    want = np.asarray(j_pointcloud_masks(jnp.asarray(cv_mask)))
    got = pointcloud_masks(torch.from_numpy(np.moveaxis(cv_mask, -1, 1).copy())).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("roi", [None, (3, 30, 5, 50)])
def test_ply_writer_bytes_match_jax(tmp_path, roi):
    rng = np.random.default_rng(1)
    writers = (PLYWriter(min_d=3, max_d=30, roi=roi, dropout=0.75),
               JPLYWriter(min_d=3, max_d=30, roi=roi, dropout=0.75))
    for _ in range(2):
        inv = rng.uniform(0.0, 0.4, (36, 60, 1)).astype(np.float32)
        inv[rng.uniform(size=inv.shape) < 0.2] = 0.0
        image = rng.uniform(-0.5, 0.5, (36, 60, 3)).astype(np.float32)
        k = np.array([[50, 0, 30, 0], [0, 50, 18, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3)
        for w in writers:
            w.add_depthmap(inv, image, k, pose)
    files = []
    for i, w in enumerate(writers):
        with open(tmp_path / f"{i}.ply", "wb") as f:
            w.save(f)
        files.append((tmp_path / f"{i}.ply").read_bytes())
    assert files[0] == files[1] and len(chip_smoke.read_ply(tmp_path / "0.ply")) > 0


def _compare_clouds(got, want, label):
    assert len(got) == len(want), label
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=label)


def test_export_pointcloud_matches_jax(setup, tmp_path):
    root, tree, _, port_ckpt, variables = setup
    args = dict(dataset_dir=str(tree), depth_folder="image_depth_annotated", sequences=["07"],
                target_image_size=list(torch_kitti.TARGET), use_dso_poses=True,
                lidar_depth=True, dso_depth=False)
    model = MonoRec(MonoRecConfig(**MODEL_ARGS))
    load_stage_checkpoints(model, {"checkpoint_location": [port_ckpt]})
    loader = DataLoader(KittiOdometryDataset(**args), 1, shuffle=False, drop_last=False)
    port = export_pointcloud(model, loader, tmp_path / "port.ply", use_mask=False,
                             max_d=MAX_D, dropout=0.0, progress=False)
    j_loader = JDataLoader(JKitti(**args), 1, shuffle=False, drop_last=False)
    ref = j_export_pointcloud(JMonoRec(JConfig(**MODEL_ARGS)), variables, j_loader,
                              tmp_path / "jax.ply", use_mask=False, max_d=MAX_D, dropout=0.0,
                              progress=False)
    got, want = chip_smoke.read_ply(port), chip_smoke.read_ply(ref)
    assert len(want) > 0
    # Points whose depth is within the forward's budget of min_d / max_d.
    with torch.no_grad():
        inv = torch.cat([model(b)["result"] for b in loader]).numpy()
    budget = RESULT_ATOL + RESULT_RTOL * inv
    near = sum(int((np.abs(inv - 1.0 / d) <= budget).sum()) for d in (3.0, MAX_D))
    print(f"points within the forward's budget of min_d / max_d: {near}")
    assert near == 0
    _compare_clouds(got, want, "export_pointcloud")


@pytest.mark.parametrize("use_mask", [True, False])
def test_create_pointcloud_cli_matches_jax(setup, monkeypatch, use_mask):
    root, tree, jax_ckpt, port_ckpt, _ = setup
    monkeypatch.chdir(root)  # the JAX CLI lays out saved/ in the working directory
    outputs = {}
    for side, ckpt in (("jax", jax_ckpt), ("port", port_ckpt)):
        config = json.loads((CONFIGS / "test/pointcloud_monorec.json").read_text())
        config["arch"]["args"]["checkpoint_location"] = [str(ckpt)]
        config["data_set"]["args"].update(dataset_dir=str(tree),
                                          target_image_size=list(torch_kitti.TARGET))
        config.update(output_dir=str(root / f"{side}_{use_mask}"), use_mask=use_mask, max_d=MAX_D)
        path = root / f"pc_{side}.json"
        path.write_text(json.dumps(config))
        if side == "jax":
            j_create_pointcloud.main(["-c", str(path)])
        else:
            assert create_pointcloud.main(["-c", str(path), "--device", "cpu"]) == 0
        outputs[side] = chip_smoke.read_ply(Path(config["output_dir"]) / config["file_name"])
    _compare_clouds(outputs["port"], outputs["jax"], "create_pointcloud")
    assert np.isfinite(outputs["port"]).all()
    assert (len(outputs["port"]) == 0) == use_mask
