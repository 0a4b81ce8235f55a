"""The port's evaluation CLI against the JAX package's, on a KITTI-layout
tree (``tests/torch_kitti.py``, sequence 07, 14 frames at 60x200 read at
32x64) with the same carried weights (``tests/torch_carried.py``), each
CLI on a copy of the shipped ``eval_monorec.json`` with ``dataset_dir``,
``checkpoint_location``, ``save_dir`` and the image size replaced.

The tree's annotated depth leaves keyframes 7 and 8 (the second batch of
two) empty: every sparse metric of that batch is NaN, so both CLIs must
drop it the same way. Each metric agrees within the forward's budget,
rtol 1e-3 / atol 2e-4 (``tests/test_convert.py``); ``valid_batches``,
``num_samples`` and the JSON keys are equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monorec_tpu.cli import evaluate as j_evaluate
from monorec_tpu_torch.cli import evaluate
from tests import torch_carried, torch_kitti

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
RESULT_RTOL, RESULT_ATOL = 1e-3, 2e-4
N_FRAMES = 14  # annotated depth: samples are frames 5 .. n - 6



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
    root = tmp_path_factory.mktemp("eval")
    tree = torch_kitti.write_tree(root / "kitti", N_FRAMES, sequences=("07",))
    empty = np.zeros(torch_kitti.SIZE, np.uint16)
    for i in (7, 8):
        torch_kitti.pil_write(tree / "sequences/07/image_depth_annotated" / f"{i:06d}.png", empty)
    config = json.loads((CONFIGS / "evaluate/eval_monorec.json").read_text())
    model_args = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in config["models"][0]["args"].items() if k != "checkpoint_location"}
    jax_ckpt, port_ckpt, _ = torch_carried.write_checkpoints(root, **model_args)
    return root, tree, jax_ckpt, port_ckpt


def _config(root, tree, checkpoint, side, **evaluater):
    config = json.loads((CONFIGS / "evaluate/eval_monorec.json").read_text())
    config["models"][0]["args"]["checkpoint_location"] = [str(checkpoint)]
    config["data_loader"]["args"].update(dataset_dir=str(tree), sequences=["07"],
                                         target_image_size=list(torch_kitti.TARGET))
    config["evaluater"].update(save_dir=str(root / side), **evaluater)
    path = root / f"{side}.json"
    path.write_text(json.dumps(config))
    return path, root / side / "log" / config["name"] / config["timestamp_replacement"]


@pytest.mark.parametrize("median_scaling", [False, True])
def test_evaluate_cli_matches_jax(setup, capsys, median_scaling):
    root, tree, jax_ckpt, port_ckpt = setup
    tag = f"_ms{int(median_scaling)}"
    j_path, j_dir = _config(root, tree, jax_ckpt, "jax" + tag, median_scaling=median_scaling)
    p_path, p_dir = _config(root, tree, port_ckpt, "port" + tag, median_scaling=median_scaling)
    j_evaluate.main(["-c", str(j_path)])
    assert evaluate.main(["-c", str(p_path), "--device", "cpu"]) == 0
    assert "abs_rel_sparse_metric" in capsys.readouterr().out
    want = json.loads((j_dir / "results_0.json").read_text())
    got = json.loads((p_dir / "results_0.json").read_text())
    assert set(got) == set(want) and set(got["metrics"]) == set(want["metrics"])
    assert got["dataset"] == want["dataset"]
    g, w = got["metrics"], want["metrics"]
    assert g["num_samples"] == w["num_samples"] == N_FRAMES - 10
    assert g["valid_batches"] == w["valid_batches"] == 1.0  # the second batch is NaN
    for key in ("metrics", "metrics_correct"):
        np.testing.assert_allclose(g[key], w[key], rtol=RESULT_RTOL, atol=RESULT_ATOL,
                                   err_msg=key)
    assert np.all(np.isfinite(g["metrics"]))
    for name in json.loads(p_path.read_text())["metrics"]:
        assert g[name] == g["metrics"][json.loads(p_path.read_text())["metrics"].index(name)]


def test_evaluate_cli_writes_one_result_per_model(setup):
    """``eval_monorec_fixture_trained.json``'s two models, the second from a
    checkpoint, over its start/end slice (here the tree's first keyframe)."""
    root, tree, _, port_ckpt = setup
    config = json.loads((CONFIGS / "evaluate/eval_monorec_fixture_trained.json").read_text())
    config["models"][1]["args"]["checkpoint_location"] = [str(port_ckpt)]
    for block in config["models"]:
        block["args"].update(pretrain_mode=0)  # the carried weights hold a MaskModule
    config["data_loader"]["args"].update(dataset_dir=str(tree), start=0, end=1,
                                         target_image_size=list(torch_kitti.TARGET))
    config["evaluater"]["save_dir"] = str(root / "two")
    path = root / "two.json"
    path.write_text(json.dumps(config))
    assert evaluate.main(["-c", str(path), "--device", "cpu"]) == 0
    run_dir = root / "two" / "log" / config["name"] / "00"
    results = [json.loads((run_dir / f"results_{i}.json").read_text())["metrics"]
               for i in (0, 1)]
    for r in results:
        assert r["num_samples"] == 1 and r["valid_batches"] == 1.0
        assert np.all(np.isfinite(r["metrics"]))
    assert results[0]["metrics"] != results[1]["metrics"]  # seed-0 weights vs the checkpoint
    assert json.loads((run_dir / "config.json").read_text()) == config
