"""The port's four-stage curriculum on the CPU, through its CLIs, at 32x64,
D=4, B=2, F=2, two steps per stage: ``cli/train.py`` on
``monorec_depth.json``, then ``cli/train_monorec.py`` on
``monorec_mask.json``, ``monorec_mask_ref.json -o mask_loss`` and
``monorec_depth_ref.json -o stereo stereo_repr``. Each config is the shipped
one with its data loader swapped for ``SyntheticSweepDataloader`` (its own
``return_mvobj_mask``); the runs write under ``saved/`` in a scratch working
directory, so stages 3 and 4 find the earlier stages' checkpoints by the
shipped configs' own ``depth_cp_loc`` / ``mask_cp_loc`` paths.

Checked at each stage: the trainer starts from the earlier stages'
checkpoints (the loaded subtrees equal bit for bit), the modules the stage
trains move and the others do not. The losses' parity with the JAX package
is held by ``tests/test_torch_refinement_losses.py`` and
``tests/test_torch_refinement_feed.py``. Tolerances: none.
"""

import json
import math
import os
from pathlib import Path

import pytest
import torch

import chip_smoke
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.cli import train_monorec
from monorec_tpu_torch.train.checkpoints import load_checkpoint

H, W, D, B = 32, 64, 4, 2
CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "train" / "monorec"
# (config, CLI, loss options, the module prefixes the stage trains)
STAGES = (
    ("monorec_depth", train_cli, (), ("depth_module.",)),
    ("monorec_mask", train_monorec, (), ("att_module.",)),
    ("monorec_mask_ref", train_monorec, ("mask_loss",), ("att_module.", "depth_module.")),
    ("monorec_depth_ref", train_monorec, ("stereo", "stereo_repr"), ("depth_module.",)),
)


def _config(name: str) -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        config = json.load(f)
    config["arch"]["args"]["cv_depth_steps"] = D
    shipped = config["data_loader"]["args"]
    config["data_loader"] = {"type": "SyntheticSweepDataloader", "args": {
        "length": 6, "batch_size": B, "frame_count": 2, "target_image_size": [H, W],
        "validation_split": 2, "return_stereo": True,
        "return_mvobj_mask": int(shipped.get("return_mvobj_mask", 0))}}
    config.pop("val_data_loader", None)  # KITTI; the validation split serves instead
    config["trainer"].update(epochs=1, len_epoch=2, log_step=1, save_dir="saved/",
                             tensorboard=False)
    return config


@pytest.fixture(scope="module")
def curriculum(tmp_path_factory):
    """Each stage's config, the state before and after its run, and its log."""
    tmp = tmp_path_factory.mktemp("curriculum")
    cwd, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(tmp)
    # One intra-op thread: as fast alone at this size, and far faster
    # beside the other test workers.
    torch.set_num_threads(1)
    try:
        out = {}
        for name, cli, options, _ in STAGES:
            config = _config(name)
            path = tmp / f"{name}.json"
            path.write_text(json.dumps(config))
            # The state the stage starts from: its model as the CLI builds it.
            start = cli.build_trainer(config, "cpu", run_dir=tmp / "probe" / name)
            before = {k: v.clone() for k, v in start.model.state_dict().items()}
            argv = ["-c", str(path), "--device", "cpu"] + (["-o", *options] if options else [])
            assert cli.main(argv) == 0
            run = tmp / "saved" / "models" / name / config["trainer"]["timestamp_replacement"]
            out[name] = {"config": config, "before": before,
                         "after": load_checkpoint(run / "checkpoint.pth")["state_dict"],
                         "log": chip_smoke.train_log(run)}
        return out
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)


@pytest.mark.parametrize("stage", [s[0] for s in STAGES])
def test_stage_trains_its_modules_from_the_earlier_checkpoints(curriculum, stage):
    _, _, _, trained = next(s for s in STAGES if s[0] == stage)
    run = curriculum[stage]
    before, after = run["before"], run["after"]
    assert set(before) == set(after)
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved and all(k.startswith(trained) for k in moved), sorted(moved)[:5]
    assert all(any(k in moved for k in after if k.startswith(p) and "weight" in k) for p in trained)
    assert [r["step"] for r in run["log"]] == [0, 1]
    assert all(r["cv_uncovered"] == 0 for r in run["log"])

    # The handoff: each stage after the first starts from the earlier stages'
    # checkpoints, under the shipped configs' own paths.
    sources = {"monorec_mask_ref": {"depth_module.": "monorec_depth", "att_module.": "monorec_mask"},
               "monorec_depth_ref": {"depth_module.": "monorec_depth",
                                     "att_module.": "monorec_mask_ref"}}.get(stage, {})
    for prefix, source in sources.items():
        held = curriculum[source]["after"]
        keys = [k for k in before if k.startswith(prefix)]
        assert keys and all(torch.equal(before[k], held[k]) for k in keys), (stage, prefix)


def test_refinement_stages_log_their_losses(curriculum):
    stage3 = curriculum["monorec_mask_ref"]["log"]
    assert all(math.isfinite(r["loss"]) for r in stage3)
    assert {"mask_loss", "sdl_0", "md2l_3", "static_md2l_0", "dynamic_md2l_0", "iou"} <= set(
        stage3[0])
    stage4 = curriculum["monorec_depth_ref"]["log"]
    assert {"sdl_3", "md2l_0", "static_md2l_0", "dynamic_md2l_3", "skipped_nonfinite"} <= set(
        stage4[0])
    # skip_nonfinite_updates reads the gradients, which stay finite even
    # where a loss is NaN (no static or no moving pixel): every step applies.
    assert all(r["skipped_nonfinite"] == 0.0 for r in stage4)
