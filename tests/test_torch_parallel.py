"""Data parallelism of the port (``monorec_tpu_torch/parallel``) on the CPU:
2 gloo ranks, spawned, against one process and against the JAX package's
one-device step, at 32x64, D=4, F=2, global batch 4.

The ranks run ``tests/torch_parallel_ranks.py`` (no JAX there); this
process computes the JAX reference and the W=1 side. One spawn runs every
rank case, so the file pays the ranks' start-up once.

Tolerances: the loss dict rtol 1e-5 and the parameters after one SGD step
rtol 1e-5 / atol 5e-7, as ``tests/test_train.py`` holds an 8-device JAX step
to a 1-device one (SGD keeps the update lr * grad, so reduction-order noise
stays far below what a wrong reduction moves); against JAX the same, since
the port's step is within 2e-7 of JAX's loss and 2e-5 of its gradients at
this size. Evaluation metrics rtol 1e-5.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.spawn import ProcessException

import monorec_tpu.models.monorec as j_monorec_mod
import torch_parallel_ranks as ranks
from monorec_tpu.losses.monorec_losses import depth_loss as j_depth_loss
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch import parallel
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.loader import collate
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset
from monorec_tpu_torch.train.checkpoints import load_checkpoint
from monorec_tpu_torch.train.loggers import read_scalars
from torch_flax import fill

B, H, W, D, F = 4, ranks.H, ranks.W, ranks.D, ranks.F
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FLIP = (True, False, False, True)
RTOL, PARAM_ATOL = 1e-5, 5e-7
_RNGS = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}


def _stage1_batches() -> dict:
    ds = SyntheticSweepDataset(length=B, target_image_size=(H, W), frame_count=F)
    base = collate([ds[i] for i in range(B)])
    unequal = base["target"].copy()  # rank 0's rows keep far fewer valid pixels
    unequal[0, :20] = 0
    unequal[1, :, :40] = 0
    unequal[3, 5:9] = 0
    empty = base["target"].copy()  # rank 1's rows keep none
    empty[2:] = 0
    nan = base["keyframe"].copy()
    nan[3] = np.nan
    return {"unequal": dict(base, target=unequal), "empty_shard": dict(base, target=empty),
            "nan": dict(base, keyframe=nan)}


def _jax_steps(batches: dict, state_path: Path) -> dict:
    """The JAX one-device stage-1 step on each batch (the flip fixed):
    its loss dict and its depth-module parameters after SGD, in the port's
    keys. Writes the port's copy of the weights to ``state_path``."""
    cfg = JConfig(cv_depth_steps=D, pretrain_mode=1, augmentation="depth", pretrain_dropout=0.0)
    jm = JMonoRec(cfg)
    some = {k: jnp.asarray(v) for k, v in batches["unequal"].items()}
    shapes = jax.eval_shape(lambda b: jm.init({"params": jax.random.PRNGKey(0)}, b, False), some)
    v = fill(shapes, 3)
    torch.save(state_dict_from_flax(v["params"], v["batch_stats"]), state_path)

    @jax.jit
    def step(params, batch):
        def losses(p):
            out = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, batch, True,
                           rngs=_RNGS)
            loss_dict = j_depth_loss({**batch, **out}, 0.5, None, ())
            return loss_dict["loss"], loss_dict

        (_, loss_dict), grads = jax.value_and_grad(losses, has_aux=True)(params)
        return loss_dict, jax.tree_util.tree_map(lambda p, g: p - ranks.LR * g, params, grads)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_monorec_mod, "sample_flip_conditions", lambda rng, b: jnp.asarray(FLIP))
        for name in ("unequal", "empty_shard"):
            loss_dict, params = step(v["params"], {k: jnp.asarray(x)
                                                   for k, x in batches[name].items()})
            new = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                       v["batch_stats"])
            out[name] = ({k: float(x) for k, x in loss_dict.items()},
                         {k: t.numpy() for k, t in new.items() if k.startswith("depth_module.")})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX reference, the W=1 results, the two ranks' W=2 results, the
    ranks' spec, the work folder)."""
    tmp = tmp_path_factory.mktemp("parallel")
    batches = _stage1_batches()
    jax_ref = _jax_steps(batches, tmp / "state.pt")
    spec = {"state": str(tmp / "state.pt"), "flip": FLIP,
            "stage1_batches": {k: batches[k] for k in ("unequal", "empty_shard")},
            "nan_batch": batches["nan"],
            "stage2": ranks.stage_config("monorec_mask.json", CONFIGS),
            "stage4": ranks.stage_config("monorec_depth_ref.json", CONFIGS),
            "stage4_joint": ranks.stage_config("monorec_depth_ref.json", CONFIGS, joint_cv=True,
                                               joint_depth_decode=True)}
    w2 = parallel.launch(ranks.run_cases, 2, "cpu", (spec, str(tmp / "w2")))
    w1 = ranks.run_cases(torch.device("cpu"), spec, str(tmp / "w1"))
    return jax_ref, w1, w2, spec, tmp


def _same_ranks(w2: list, pick) -> dict:
    """``pick`` of rank 0, checked equal on rank 1 (every rank computes the
    global values from the same all-reduced sums)."""
    a, b = pick(w2[0]), pick(w2[1])
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
    return a


def _assert_step_close(got: dict, want_loss: dict, want_params: dict) -> None:
    for k, v in want_loss.items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=RTOL, atol=1e-8, err_msg=k)
    assert set(got["params"]) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=RTOL, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("batch", ["unequal", "empty_shard"])
def test_two_rank_stage1_step_equals_the_jax_one_device_step(runs, batch):
    """(a) the shards' valid-target counts differ, so the mean of per-rank
    losses is another function; (d) rank 1's shard has no valid target,
    and no value turns NaN where one process has none."""
    jax_ref, w1, w2, *_ = runs
    want_loss, want_params = jax_ref[batch]
    got = _same_ranks(w2, lambda r: r["stage1"][batch])
    _assert_step_close(got, want_loss, want_params)
    _assert_step_close(w1["stage1"][batch], want_loss, want_params)
    assert all(np.isfinite(v) for v in got["loss"].values())
    assert np.isfinite(got["metrics"]).all()
    np.testing.assert_allclose(got["metrics"], w1["stage1"][batch]["metrics"], rtol=RTOL)
    naive = np.mean([r["stage1"][batch]["shard_loss"] for r in w2])
    assert abs(naive - want_loss["loss"]) > 100 * RTOL * abs(want_loss["loss"])


@pytest.mark.parametrize("stage", ["stage2", "stage4", "stage4_joint"])
def test_two_rank_monorec_step_equals_one_process(runs, stage):
    """(b) stage 2 (mask_loss, the mask augmentation and the MaskModule's
    dropout drawn for the global batch), (c) stage 4 (``-o stereo
    stereo_repr``, the mask at about half moving pixels) and stage 4 under
    ``joint_cv`` and ``joint_depth_decode`` (each rank's rows in one grouped
    cost volume and one 2B-batch decode)."""
    _, w1, w2, *_ = runs
    got = _same_ranks(w2, lambda r: r[stage])
    want = w1[stage]
    assert set(got["loss"]) == set(want["loss"])
    assert all(np.isfinite(v) for v in want["loss"].values())
    _assert_step_close(got, want["loss"], want["params"])
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL)


def test_joint_stage4_step_equals_the_separate_passes(runs):
    """In one process, stage 4 under both joint flags takes the separate
    passes' step: the same loss dict and the same parameters after it."""
    _, w1, *_ = runs
    _assert_step_close(w1["stage4_joint"], w1["stage4"]["loss"], w1["stage4"]["params"])
    np.testing.assert_allclose(w1["stage4_joint"]["metrics"], w1["stage4"]["metrics"], rtol=RTOL)


def test_two_rank_evaluation_equals_one_process(runs):
    """(e) every field of the log, over batches of 2 and a last odd one."""
    _, w1, w2, *_ = runs
    want = w1["eval"]
    for r in w2:
        assert set(r["eval"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], v, rtol=RTOL, err_msg=k)
    assert want["num_samples"] == 7 and want["valid_batches"] == 4


def test_each_rank_reads_its_rows_of_the_one_process_order(runs):
    """(f) the same shuffled split and order on every rank; rank r decodes
    only its rows of each global batch."""
    _, w1, w2, *_ = runs
    one, (r0, r1) = w1["loader"], (w2[0]["loader"], w2[1]["loader"])
    assert [a + b for a, b in zip(r0["batches"], r1["batches"])] == one["batches"]
    assert [len(b) for b in one["batches"]] == [4, 4, 2]
    assert r0["sharded"] == r1["sharded"] == [True] * 3 and one["sharded"] == [False] * 3
    for r in (r0, r1):
        assert r["reads"] == sorted(i for b in r["batches"] for i in b)
        assert r["validation"] == one["validation"]
    assert sorted(r0["reads"] + r1["reads"]) == one["reads"]


def test_an_indivisible_batch_is_replicated_with_one_warning(runs):
    """(g) a batch of 3 on 2 ranks: every rank keeps all of it, once
    warned; a batch of 4 is cut in halves."""
    _, _, w2, *_ = runs
    for rank, r in enumerate(w2):
        rows = r["shard"]["rows"]
        assert rows[:2] == [([0, 1, 2], False, 2.0)] * 2
        assert rows[2] == ([2 * rank, 2 * rank + 1], True, 2.0)
        assert len(r["shard"]["warnings"]) == 1 and "replicating" in r["shard"]["warnings"][0]


def test_a_non_finite_gradient_on_one_rank_skips_the_step_on_both(runs):
    """(i) rank 1 holds the NaN sample; rank 0's own gradients are finite,
    but the guard reads the all-reduced ones."""
    _, w1, w2, *_ = runs
    assert [r["skip"]["local_finite"] for r in w2] == [True, False]
    for r in w2 + [w1]:
        assert r["skip"]["skipped"] == 1.0 and r["skip"]["unchanged"]


def _cli_config(tmp_path, name: str) -> str:
    with open(CONFIGS / "smoke" / "train_synthetic.json") as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=D)
    config["data_loader"]["args"].update(length=8, batch_size=4, target_image_size=[H, W],
                                         validation_split=0, num_workers=1)
    config["optimizer"] = {"type": "SGD", "args": {"lr": ranks.LR}}
    config["trainer"].update(save_dir=str(tmp_path / name), log_step=1, len_epoch=2,
                             module_timing=False)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(config))
    return str(path)


def test_cli_trains_on_two_ranks_rank_zero_writes_and_one_rank_resumes(tmp_path):
    """(h) ``cli.train`` with ``--world-size 2`` on the CPU: the run
    directory holds what one writer writes, the losses and the checkpoint
    equal the one-process run's, and that checkpoint resumes at W=1."""
    runs = {}
    for n in (1, 2):
        assert train_cli.main(["-c", _cli_config(tmp_path, f"w{n}"), "--device", "cpu",
                               "--world-size", str(n)]) == 0
        runs[n] = tmp_path / f"w{n}" / "models" / "smoke_synthetic" / "smoke"
    assert sorted(p.name for p in runs[2].iterdir()) == sorted(p.name for p in runs[1].iterdir())
    lines = {n: (runs[n] / "tb" / "metrics.jsonl").read_text().splitlines() for n in runs}
    assert len(lines[2]) == len(lines[1]) > 0
    losses = {n: read_scalars(runs[n] / "tb" / "metrics.jsonl") for n in runs}
    assert sorted(losses[2]) == sorted(losses[1]) == [0, 1]
    for step in (0, 1):
        np.testing.assert_allclose(losses[2][step]["loss"], losses[1][step]["loss"], rtol=RTOL)
    sd = {n: load_checkpoint(runs[n] / "checkpoint.pth")["state_dict"] for n in runs}
    for k, t in sd[1].items():
        np.testing.assert_allclose(sd[2][k].numpy(), t.numpy(), rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    config = json.loads(Path(_cli_config(tmp_path, "resumed")).read_text())
    trainer = train_cli.build_trainer(config, "cpu", run_dir=tmp_path / "resumed_run")
    trainer.resume(runs[2] / "checkpoint.pth")
    assert trainer.start_epoch == 2
    for k, t in trainer.model.state_dict().items():
        assert torch.equal(t, sd[2][k]), k


def test_launch_fails_loudly(tmp_path):
    """A rank that raises fails the launch; a world the cards cannot hold
    is refused before any process starts, and nothing shrinks it."""
    # The first rank to end may be either: rank 1 raising, or rank 0 torn
    # out of its barrier.
    with pytest.raises(ProcessException):
        parallel.launch(ranks.fail_on_rank_1, 2, "cpu")
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="no CUDA device is visible"):
            parallel.launch(ranks.fail_on_rank_1, None, "cuda")
    with pytest.raises(ValueError, match="ranks need"):
        parallel.launch(ranks.fail_on_rank_1, torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="names one card"):
        parallel.launch(ranks.fail_on_rank_1, 2, "cuda:0")


def test_one_rank_runs_without_a_group_unless_asked(runs):
    """One rank runs in the calling process with no group, so a one-card
    run has no collective in it; ``group=True`` joins a group of one (gloo
    here, NCCL on a card), whose collectives leave the step and the
    evaluation as they are, and where a loader that does not say whether
    its batch is a shard is refused."""
    _, w1, _, spec, tmp = runs
    plain, = parallel.launch(ranks.group_state, 1, "cpu", (spec, str(tmp / "g0")))
    grouped, = parallel.launch(ranks.group_state, 1, "cpu", (spec, str(tmp / "g1")), group=True)
    assert not parallel.is_active()
    assert {k: plain[k] for k in ("active", "world", "device", "refused")} == {
        "active": False, "world": 1, "device": "cpu", "refused": None}
    assert {k: grouped[k] for k in ("active", "world", "device", "refused")} == {
        "active": True, "world": 1, "device": "cpu", "refused": True}
    for got in (plain, grouped):
        want = w1["stage1"]["unequal"]
        _assert_step_close(got["stage1"], want["loss"], want["params"])
        for k, v in w1["eval"].items():
            np.testing.assert_allclose(got["eval"][k], v, rtol=RTOL, err_msg=k)
