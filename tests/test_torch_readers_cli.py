"""The three shipped configs that read RobotCar and TUM mono VO, through the
port's ``config.build_dataset``, ``cli.evaluate`` and
``cli.create_pointcloud`` on the CPU, on trees the tests write
(``tests/torch_trees.py``) with the folders replaced and the size cut to
32x64 (RobotCar read at 96x128 with scale 0.5, TUM mono VO at 60x80 with
``end`` cut to the tree, the export rois scaled alike) and seed-0 weights
saved as a port checkpoint.

Each builds its dataset as shipped. The shipped RobotCar cutout,
0.333333333333333, keeps one row more than a third should leave (33 of
48 here, 321 of 480 at RobotCar's native size), which neither package's
model takes (``tests/test_torch_robotcar.py``, ROADMAP Queue 3), so the
CLIs run RobotCar with the cutout 1/3 to the double's last digit.

``eval_monorec_oxrc.json`` gives its 7 sparse metrics, finite, over both
batches of 4; ``pointcloud_monorec_oxrc.json`` and
``pointcloud_monorec_tmvo.json`` (F=4) write PLYs that parse, with points
when the mask is off. Seed weights predict 45-400 m, so ``max_d`` is raised
to 1000 as ``tests/test_torch_pointcloud.py`` does.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.cli import create_pointcloud, evaluate
from monorec_tpu_torch.models import MonoRec
from monorec_tpu_torch.train.checkpoints import save_checkpoint
from tests import torch_trees

OXRC_EVAL = "evaluate/eval_monorec_oxrc.json"
OXRC_PC = "test/pointcloud_monorec_oxrc.json"
TMVO_PC = "test/pointcloud_monorec_tmvo.json"
TUM_SAMPLES = torch_trees.TUM_FRAMES - 4  # F=4


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
    root = tmp_path_factory.mktemp("readers_cli")
    robotcar = torch_trees.write_robotcar(root / "robotcar")
    tum = torch_trees.write_tum_mono(root / "tum")
    (model_cfg, _), = config_mod.build_models(torch_trees.shipped(OXRC_EVAL))
    model = MonoRec(model_cfg, "cpu", generator=torch.Generator().manual_seed(0))
    checkpoint = save_checkpoint(root / "checkpoint.pth", model,
                                 torch.optim.SGD(model.parameters(), lr=0.0), 0, 0.0, {})
    return root, robotcar, tum, checkpoint


def _data_args(config: str, block: dict, robotcar, tum) -> dict:
    if config == TMVO_PC:
        return dict(block["args"], dataset_dir=str(tum),
                    target_image_size=list(torch_trees.TARGET))
    return torch_trees.robotcar_args(block, robotcar)


NATIVE = {OXRC_PC: (320, 640), TMVO_PC: (480, 640)}


@pytest.mark.parametrize("config", [OXRC_EVAL, OXRC_PC, TMVO_PC])
def test_shipped_config_builds_its_dataset(setup, config):
    _, robotcar, tum, _ = setup
    data = torch_trees.shipped(config)
    block = data.get("data_loader") or data["data_set"]
    args = _data_args(config, block, robotcar, tum)
    if config != TMVO_PC:
        args["cutout"] = block["args"]["cutout"]  # as shipped
    dataset = config_mod.build_dataset(block["type"], args)
    sample = dataset[len(dataset) - 1]
    frames, size = (4, torch_trees.TARGET) if config == TMVO_PC else (2, (33, 64))
    assert sample["keyframe"].shape == (*size, 3)
    assert sample["frames"].shape == (frames, *size, 3)
    assert sample["target"].shape == (*size, 1)
    if config != TMVO_PC:
        assert (sample["target"] > 0).any()


def test_evaluate_cli_on_oxrc(setup):
    root, robotcar, tum, checkpoint = setup
    config = torch_trees.shipped(OXRC_EVAL)
    config["models"][0]["args"]["checkpoint_location"] = [str(checkpoint)]
    config["data_loader"]["args"] = _data_args(OXRC_EVAL, config["data_loader"], robotcar, tum)
    config["evaluater"].update(save_dir=str(root / "eval"), verbosity=0)
    path = root / "eval.json"
    path.write_text(json.dumps(config))
    assert evaluate.main(["-c", str(path), "--device", "cpu"]) == 0
    run_dir = root / "eval" / "log" / config["name"] / config["timestamp_replacement"]
    result = json.loads((run_dir / "results_0.json").read_text())["metrics"]
    n_samples = torch_trees.ROBOTCAR_FRAMES - 2
    assert result["num_samples"] == n_samples and result["valid_batches"] == n_samples // 4
    assert len(result["metrics"]) == 7 and np.all(np.isfinite(result["metrics"]))


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("config", [OXRC_PC, TMVO_PC])
def test_create_pointcloud_cli(setup, config, use_mask):
    root, robotcar, tum, checkpoint = setup
    data = torch_trees.shipped(config)
    data["arch"]["args"]["checkpoint_location"] = [str(checkpoint)]
    data["data_set"]["args"] = _data_args(config, data["data_set"], robotcar, tum)
    out = root / f"pc_{config.split('/')[-1][:-5]}_{use_mask}"
    data.update(output_dir=str(out), use_mask=use_mask, max_d=1000,
                roi=torch_trees.cut_roi(data["roi"], NATIVE[config]))
    if config == TMVO_PC:
        data["end"] = TUM_SAMPLES
    path = root / f"{out.name}.json"
    path.write_text(json.dumps(data))
    assert create_pointcloud.main(["-c", str(path), "--device", "cpu"]) == 0
    cloud = chip_smoke.read_ply(out / data["file_name"])
    assert np.isfinite(cloud).all()
    assert use_mask or len(cloud) > 0
