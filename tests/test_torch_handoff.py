"""The stage handoff of the port on the CPU: a stage-1 run
(``cli/train.py``) and a stage-2 run (``cli/train_monorec.py``) write their
checkpoints into ``tmp_path`` at 32x64, D=4, B=2, F=2; a pretrain-mode-0
model built from a config that names them (``depth_cp_loc``,
``mask_cp_loc``; ``checkpoint_location``) then holds their tensors.

Tolerances: none. The loaded subtrees are equal bit for bit to the
checkpoints' and the rest to the model's own seed-0 initial weights.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.cli import train_monorec
from monorec_tpu_torch.models import MonoRec
from monorec_tpu_torch.train import MonoRecTrainer
from monorec_tpu_torch.train.checkpoints import load_checkpoint

H, W, D, B = 32, 64, 4, 2
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LOADER = {"length": 6, "batch_size": B, "frame_count": 2, "target_image_size": [H, W],
          "validation_split": 2, "return_stereo": True}


def _stage_config(name: str, tmp_path, **arch) -> dict:
    with open(CONFIGS / "train" / "monorec" / name) as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=D, **arch)
    config["data_loader"] = {"type": "SyntheticSweepDataloader",
                             "args": dict(LOADER, return_mvobj_mask=2)}
    config.pop("val_data_loader", None)  # KITTI; the validation split serves instead
    config["trainer"].update(epochs=1, len_epoch=2, log_step=1, save_dir=str(tmp_path),
                             tensorboard=False)
    return config


def _run(tmp_path, config: dict, main) -> Path:
    path = tmp_path / f"{config['name']}.json"
    path.write_text(json.dumps(config))
    assert main(["-c", str(path), "--device", "cpu"]) == 0
    return tmp_path / "models" / config["name"] / config["trainer"]["timestamp_replacement"]


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Checkpoints of a stage-1 and a stage-2 run through the CLIs."""
    tmp_path = tmp_path_factory.mktemp("stages")
    depth = _stage_config("monorec_depth.json", tmp_path)
    depth["data_loader"]["args"]["return_mvobj_mask"] = 0
    mask = _stage_config("monorec_mask.json", tmp_path)
    return {"depth": _run(tmp_path, depth, train_cli.main),
            "mask": _run(tmp_path, mask, train_monorec.main), "tmp": tmp_path}


def test_stage2_run_trains_the_mask_module_only(stages):
    run = stages["mask"]
    lines = [json.loads(s) for s in (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["cv_uncovered"] == 0 for r in lines)
    assert {"acc", "prec", "rec", "iou"} <= set(lines[0])
    state = load_checkpoint(run / "checkpoint.pth")["state_dict"]
    fresh = _fresh(pretrain_mode=2).state_dict()
    assert set(state) == set(fresh) and not any(k.startswith("depth_module.") for k in state)
    moved = {k for k in state if not torch.equal(state[k], fresh[k])}
    assert moved and all(k.startswith("att_module.") for k in moved)


def _fresh(**arch) -> MonoRec:
    cfg = config_mod.build_model_config({"cv_depth_steps": D, **arch})
    return MonoRec(cfg, generator=torch.Generator().manual_seed(0))


def _handoff_trainer(stages, **arch):
    config = _stage_config("monorec_mask_ref.json", stages["tmp"], **arch)
    config["loss"] = "mask_loss"  # the stage-3 loss waits for ROADMAP item 16
    trainer = train_monorec.build_trainer(config, "cpu", run_dir=stages["tmp"] / "handoff")
    assert isinstance(trainer, MonoRecTrainer)
    return trainer


def _assert_holds(state, source, prefix):
    keys = [k for k in state if k.startswith(prefix)]
    assert keys
    for k in keys:
        assert torch.equal(state[k], source[k]), k


def test_mode0_model_loads_depth_and_mask_subtrees(stages):
    # The shipped configs name ".../checkpoint"; the port's file is
    # ".../checkpoint.pth", which the loader finds.
    trainer = _handoff_trainer(
        stages, depth_cp_loc=[str(stages["depth"] / "checkpoint")],
        mask_cp_loc=[str(stages["mask"] / "checkpoint.pth")])
    state = trainer.model.state_dict()
    depth = load_checkpoint(stages["depth"] / "checkpoint.pth")["state_dict"]
    mask = load_checkpoint(stages["mask"] / "checkpoint.pth")["state_dict"]
    fresh = _fresh(pretrain_mode=0).state_dict()
    _assert_holds(state, depth, "depth_module.")
    _assert_holds(state, mask, "att_module.")
    _assert_holds(state, fresh, "_feature_extractor.")
    assert set(state) == set(fresh)
    assert not torch.equal(state["depth_module.enc.0.0.conv_y.weight"],
                           fresh["depth_module.enc.0.0.conv_y.weight"])


def test_checkpoint_location_loads_every_tensor_both_hold(stages):
    depth = load_checkpoint(stages["depth"] / "checkpoint.pth")["state_dict"]
    mask = load_checkpoint(stages["mask"] / "checkpoint.pth")["state_dict"]
    fresh = _fresh(pretrain_mode=0).state_dict()
    trainer = _handoff_trainer(stages, checkpoint_location=str(stages["depth"] / "checkpoint.pth"),
                               mask_cp_loc=[], depth_cp_loc=[])
    state = trainer.model.state_dict()
    _assert_holds(state, depth, "depth_module.")
    _assert_holds(state, depth, "_feature_extractor.")
    _assert_holds(state, fresh, "att_module.")  # the stage-1 model has none
    # A list loads in order, each file what it holds.
    trainer = _handoff_trainer(
        stages, checkpoint_location=[str(stages["mask"] / "checkpoint.pth"),
                                     str(stages["depth"] / "checkpoint.pth")],
        mask_cp_loc=[], depth_cp_loc=[])
    state = trainer.model.state_dict()
    _assert_holds(state, mask, "att_module.")
    _assert_holds(state, depth, "depth_module.")


def test_checkpoint_keys_are_read_and_imagenet_weights_still_raise():
    assert config_mod.checkpoint_locations(
        {"checkpoint_location": "a.pth", "mask_cp_loc": [], "depth_cp_loc": ["b", "c"]}
    ) == {"checkpoint_location": ["a.pth"], "depth_cp_loc": ["b", "c"]}
    with pytest.raises(NotImplementedError, match="11b"):
        config_mod.build_model_config({"imagenet_weights": "resnet18.pth"})
