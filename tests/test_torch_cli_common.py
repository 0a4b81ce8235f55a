"""The port's shared CLI surface (``monorec_tpu_torch/cli/common.py``) and
the trainer's per-module timing, at a tiny size on the CPU: ``-r`` and
``-o`` on ``cli.evaluate`` and ``cli.create_pointcloud`` (``-r`` reads the
``config.json`` beside a checkpoint, updated by ``-c``), the JAX trainer's
``*_module_time`` tags from a stage-1 run through ``cli.train``, and an
``imagenet_weights`` file injected by that run."""

import inspect
import json
import re
from pathlib import Path

import pytest
import torch

from chip_smoke import torchvision_resnet
from monorec_tpu.train.trainer import Trainer as JTrainer
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.cli import common, create_pointcloud, evaluate
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.models import MonoRec
from monorec_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from monorec_tpu_torch.train.loggers import read_scalars
from tests import torch_kitti

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
D = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: torch's default of one per core oversubscribes
    the cores beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return torch_kitti.write_tree(tmp_path_factory.mktemp("cli") / "kitti", 14,
                                  sequences=("07",))


def _run_dir(root: Path, config: dict) -> Path:
    """A run directory as training leaves it: ``config.json`` beside a
    ``checkpoint.pth`` (seed-0 weights of the config's model)."""
    run = root / "run"
    run.mkdir(parents=True)
    args = (config.get("models") or [config["arch"]])[0]["args"]
    model = MonoRec(config_mod.build_model_config(args), generator=torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(run / "checkpoint.pth", model, torch.optim.SGD(model.parameters(), 0.1),
                           1, 0.0, config)
    args["checkpoint_location"] = [str(ckpt)]
    (run / "config.json").write_text(json.dumps(config))
    return run


def test_evaluate_reads_the_run_config_beside_the_checkpoint(tree, tmp_path, capsys):
    config = json.loads((CONFIGS / "evaluate/eval_monorec.json").read_text())
    config["models"][0]["args"]["cv_depth_steps"] = D
    config["data_loader"]["args"].update(dataset_dir=str(tree), sequences=["07"],
                                         target_image_size=list(torch_kitti.TARGET))
    config["evaluater"].update(save_dir=str(tmp_path / "by_c"), verbosity=0)
    run = _run_dir(tmp_path, config)
    out = "log/Eval_monorec/00/results_0.json"

    assert evaluate.main(["-c", str(run / "config.json"), "-d", "cpu"]) == 0
    by_c = json.loads((tmp_path / "by_c" / out).read_text())
    (tmp_path / "by_c" / out).unlink()
    assert evaluate.main(["-r", str(run / "checkpoint.pth"), "-d", "cpu", "-o", "any"]) == 0
    assert json.loads((tmp_path / "by_c" / out).read_text()) == by_c
    # -c updates the run's config: here its evaluater block.
    update = tmp_path / "update.json"
    update.write_text(json.dumps({"evaluater": dict(config["evaluater"],
                                                    save_dir=str(tmp_path / "by_r"))}))
    assert evaluate.main(["-r", str(run / "checkpoint.pth"), "-c", str(update), "-d", "cpu"]) == 0
    assert json.loads((tmp_path / "by_r" / out).read_text()) == by_c
    assert "abs_rel_sparse_metric" in capsys.readouterr().out


def test_create_pointcloud_takes_r_and_o(tree, tmp_path):
    config = json.loads((CONFIGS / "test/pointcloud_monorec.json").read_text())
    config["arch"]["args"]["cv_depth_steps"] = D
    config["data_set"]["args"].update(dataset_dir=str(tree),
                                      target_image_size=list(torch_kitti.TARGET))
    config.update(output_dir=str(tmp_path / "clouds"), use_mask=False, max_d=1000)
    run = _run_dir(tmp_path, config)
    assert create_pointcloud.main(["-r", str(run / "checkpoint.pth"), "-o", "x", "-d",
                                   "cpu"]) == 0
    assert (tmp_path / "clouds" / config["file_name"]).stat().st_size > 0


def test_parser_defaults_to_the_card_and_reads_overrides(tmp_path):
    args = common.train_overrides(common.standard_parser("x")).parse_args([])
    assert args.device == "cuda" and args.options == [] and args.resume is None
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"optimizer": {"args": {"lr": 1.0}},
                                "data_loader": {"args": {"batch_size": 1}}}))
    args = common.train_overrides(common.standard_parser("x")).parse_args(
        ["-c", str(path), "--lr", "0.5", "--bs", "3"])
    config = common.parse_config(args, with_train_overrides=True)
    assert config["optimizer"]["args"]["lr"] == 0.5
    assert config["data_loader"]["args"]["batch_size"] == 3
    assert common.parse_config(args)["optimizer"]["args"]["lr"] == 1.0


def _jax_timing_tags():
    """The tags the JAX trainer's ``_module_times`` writes."""
    source = inspect.getsource(JTrainer._module_times)
    return set(re.findall(r'times\["(\w+_module_time)"\]', source))


@pytest.mark.parametrize("pretrain_mode", [1, 0])
def test_module_timing_writes_the_jax_tags(tmp_path, capsys, pretrain_mode):
    """A stage-1 run through ``cli.train`` with ``module_timing``; stage 1
    (mode 1) has no MaskModule, mode 0 all four submodules. The run also
    loads a seeded ImageNet file from ``imagenet_weights``: the frozen
    encoder of its checkpoint is the file's."""
    weights = torchvision_resnet(7)
    torch.save(weights, tmp_path / "resnet18.pth")
    with open(CONFIGS / "smoke" / "train_synthetic.json") as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=D, pretrain_mode=pretrain_mode,
                                  imagenet_weights=str(tmp_path / "resnet18.pth"))
    config["data_loader"]["args"].update(length=6, batch_size=2, target_image_size=[32, 64],
                                         validation_split=2)
    config["trainer"].update(save_dir=str(tmp_path), log_step=2, len_epoch=3, epochs=1,
                             module_timing=True, tensorboard=False)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    assert train_cli.main(["-c", str(path), "--device", "cpu"]) == 0
    assert "RANDOM" not in capsys.readouterr().err

    run = tmp_path / "models" / config["name"] / config["trainer"]["timestamp_replacement"]
    scalars = read_scalars(run / "tb" / "metrics.jsonl")
    want = _jax_timing_tags()
    if pretrain_mode == 1:
        want -= {"mask_module_time"}
    assert len(_jax_timing_tags()) == 4
    for step in (0, 1, 2):
        timed = {k for k in scalars[step] if k.endswith("_module_time")}
        assert timed == (want if step % 2 == 0 else set()), step
        assert all(scalars[step][k] > 0 for k in timed)
    log = (run / "info.log").read_text()
    assert "cv=" in log and "resnet=" in log and ("mask=" in log) == (pretrain_mode == 0)

    state = load_checkpoint(run / "checkpoint.pth")["state_dict"]
    for key, value in weights.items():
        if not key.startswith("fc."):
            assert torch.equal(state["_feature_extractor.encoder." + key], value), key
