"""The port's stage-1 training path against the JAX package on the CPU:
the optimizer and schedule against optax, the train forward (depth flip,
mode-1 CV-mask dropout) and one whole training step against flax with the
JAX weights carried over by ``state_dict_from_flax``, and the trainer, its
checkpoints and the CLI at a tiny size.

Tolerances: optimizer updates atol 1e-7 (both float32, the same rule); the
train forward as the eval forward (``tests/test_torch_slice.py``: cost
volumes atol 2e-4, inverse depths rtol 1e-3 / atol 2e-4); the step's loss
dict rtol 5e-4 / atol 1e-5 (the full-chain reprojection budget) and its
depth-module gradients within 1e-3 of each tensor's largest gradient (they
carry the forward's ~1e-4 cost-volume differences through the whole
decoder; 2.0e-4 measured at this size).
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import monorec_tpu.models.monorec as j_monorec_mod
import monorec_tpu_torch.models.monorec as t_monorec_mod
from monorec_tpu.losses.monorec_losses import depth_loss as j_depth_loss
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu.train.state import make_optimizer as j_make_optimizer
from monorec_tpu.train.state import make_schedule as j_make_schedule
from monorec_tpu_torch import config as config_mod
from monorec_tpu_torch.cli import train as train_cli
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.loader import collate
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset, batch_to_torch
from monorec_tpu_torch.losses import depth_loss
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train import apply_gradients_guarded, make_optimizer, make_schedule
from monorec_tpu_torch.train.checkpoints import load_checkpoint

B, H, W, D, F = 2, 32, 64, 4, 2
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


# ----- optimizer and schedule ------------------------------------------------


@pytest.mark.parametrize("opt_cfg,sched_cfg", [
    ({"type": "Adam", "args": {"lr": 1e-3, "weight_decay": 0, "amsgrad": True}},
     {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}}),
    ({"type": "Adam", "args": {"lr": 1e-3, "amsgrad": False}}, None),
    ({"type": "Adam", "args": {"lr": 2e-3, "weight_decay": 0.1, "betas": [0.8, 0.99]}},
     {"type": "StepLR", "args": {"step_size": 2, "gamma": 0.1}}),
])
def test_adam_matches_optax(opt_cfg, sched_cfg):
    rng = np.random.default_rng(0)
    # Parameters below 0.5, so one float32 ulp (< 6e-8) stays inside atol.
    params = [(0.1 * rng.normal(size=s)).astype(np.float32) for s in ((4, 3), (5,))]
    # Large gradients first, then small ones: amsgrad's maximum matters.
    grads = [[(rng.normal(size=p.shape) * s).astype(np.float32) for p in params]
             for s in (3.0, 0.1, 0.5)]
    tx = j_make_optimizer(opt_cfg, sched_cfg, steps_per_epoch=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_optimizer(tp, opt_cfg, sched_cfg, steps_per_epoch=2)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=1e-7)


def test_amsgrad_is_optax_rule_not_torch_optim():
    """optax maxes the bias-corrected second moment, torch.optim.Adam the raw
    one: equal on the first step, different from the second on."""
    p0 = torch.tensor([1.0, -2.0])
    grads = [torch.tensor([3.0, 0.5]), torch.tensor([0.1, 0.2])]
    ours = p0.clone().requires_grad_()
    theirs = p0.clone().requires_grad_()
    opt = make_optimizer([ours], {"type": "Adam", "args": {"lr": 0.1, "amsgrad": True}})
    ref = torch.optim.Adam([theirs], lr=0.1, amsgrad=True)
    for step, g in enumerate(grads):
        ours.grad, theirs.grad = g.clone(), g.clone()
        opt.step()
        ref.step()
        same = torch.allclose(ours, theirs, rtol=0, atol=1e-6)
        assert same == (step == 0)


def test_step_lr_matches_make_schedule_at_epoch_boundaries():
    cfg = {"type": "StepLR", "args": {"step_size": 3, "gamma": 0.1}}
    ours, ref = make_schedule(1e-3, cfg, 5), j_make_schedule(1e-3, cfg, 5)
    for step in (0, 1, 14, 15, 16, 29, 30, 31, 65):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    assert make_schedule(0.5, None, 5)(1000) == 0.5


@pytest.mark.parametrize("opt_cfg,sched_cfg", [
    ({"type": "SGD", "args": {"lr": 0.1}}, None),
    ({"type": "Adam", "args": {"lr": 0.1}}, {"type": "CosineAnnealingLR", "args": {}}),
])
def test_other_optimizers_and_schedules_are_not_ported_yet(opt_cfg, sched_cfg):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make_optimizer([torch.zeros(1, requires_grad=True)], opt_cfg, sched_cfg)


def test_guarded_update_skips_non_finite_gradients():
    p = torch.ones(3, requires_grad=True)
    opt = make_optimizer([p], {"type": "Adam", "args": {"lr": 0.1, "amsgrad": True}})
    p.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert apply_gradients_guarded(opt, True) == 1.0
    assert torch.equal(p.detach(), torch.ones(3)) and not opt.state[p]
    p.grad = torch.tensor([1.0, 1.0, 0.0])
    assert apply_gradients_guarded(opt, True) == 0.0
    assert opt.state[p]["step"] == 1 and p[0] < 1.0
    assert apply_gradients_guarded(opt, False) is None


# ----- train forward and the stage-1 step against flax -----------------------


@functools.lru_cache(maxsize=None)
def _flax_variables():
    model = JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=1))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    v = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False))(batch)
    return jax.tree_util.tree_map(np.asarray, v)


@functools.lru_cache(maxsize=None)
def _batch_cached():
    ds = SyntheticSweepDataset(length=B, target_image_size=(H, W), frame_count=F)
    return collate([ds[i] for i in range(B)])


def _batch():
    return dict(_batch_cached())


def _models(**cfg):
    v = _flax_variables()
    jm = JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=1, **cfg))
    tm = MonoRec(MonoRecConfig(cv_depth_steps=D, pretrain_mode=1, **cfg))
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, tm, v


def _patch_flip(monkeypatch, cond):
    cond = np.asarray(cond)
    monkeypatch.setattr(j_monorec_mod, "sample_flip_conditions", lambda rng, b: jnp.asarray(cond))
    monkeypatch.setattr(t_monorec_mod, "sample_flip_conditions",
                        lambda gen, b: torch.from_numpy(cond))


def _nchw(a, lead=1):
    return np.moveaxis(np.asarray(a), -1, lead)


_RNGS = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}


@pytest.mark.parametrize("dropout,dropout_mode,flip", [
    (0.0, 0, (True, False)), (1.0, 0, (False, True)), (1.0, 1, (True, True))])
def test_train_forward_matches_flax(monkeypatch, dropout, dropout_mode, flip):
    _patch_flip(monkeypatch, flip)
    cfg = dict(augmentation="depth", pretrain_dropout=dropout, pretrain_dropout_mode=dropout_mode)
    jm, tm, v = _models(**cfg)
    nb = _batch()
    ref = jax.jit(lambda b: jm.apply(v, b, True, rngs=_RNGS))(
        {k: jnp.asarray(x) for k, x in nb.items()})
    with torch.no_grad():
        out = tm(batch_to_torch(nb, "cpu"), train=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out["cv_mask"].numpy(), _nchw(ref["cv_mask"]), atol=0)
    np.testing.assert_allclose(out["cost_volume"].numpy(), _nchw(ref["cost_volume"]), atol=2e-4)
    np.testing.assert_allclose(out["single_frame_cvs"].numpy(),
                               _nchw(ref["single_frame_cvs"], 2), atol=2e-4)
    for p, r in zip(out["predicted_inverse_depths"], ref["predicted_inverse_depths"]):
        np.testing.assert_allclose(p.numpy(), _nchw(r), rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(out["result"].numpy(), _nchw(ref["result"]), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("mode", [0, 1])
def test_cv_mask_dropout_draws_blocks_or_samples(mode):
    tm = MonoRec(MonoRecConfig(cv_depth_steps=D, pretrain_mode=1, pretrain_dropout=0.5,
                               pretrain_dropout_mode=mode))
    kf = torch.zeros(8, 3, H, W)
    mask = tm._cv_mask_dropout(kf, torch.Generator().manual_seed(3))
    assert mask.shape == (8, 1, H, W)
    assert set(mask.unique().tolist()) == {0.0, 2.0}  # Bernoulli(0.5) / 0.5
    block = 8 if mode == 0 else H
    tiles = mask.unfold(2, block, block).unfold(3, 8 if mode == 0 else W, 8 if mode == 0 else W)
    assert (tiles == tiles[..., :1, :1]).all()  # constant over each 8x8 block / sample


def test_stage1_step_matches_jax_grad(monkeypatch):
    """One stage-1 step: the train forward with a fixed flip, depth_loss,
    and the gradients of the depth module's parameters."""
    _patch_flip(monkeypatch, (True, False))
    cfg = dict(augmentation="depth", pretrain_dropout=0.0)
    jm, tm, v = _models(**cfg)
    nb = _batch()
    jb = {k: jnp.asarray(x) for k, x in nb.items()}

    def losses(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb, True, rngs=_RNGS)
        loss_dict = j_depth_loss({**jb, **out}, 0.5, None, ())
        return loss_dict["loss"], loss_dict

    (_, j_dict), j_grads = jax.jit(jax.value_and_grad(losses, has_aux=True))(v["params"])
    j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
    assert not np.abs(j_grads["encoder"]["Conv_0"]["kernel"]).any()  # frozen encoder

    batch = batch_to_torch(nb, "cpu")
    out = tm(batch, train=True, generator=torch.Generator().manual_seed(0))
    t_dict = depth_loss({**batch, **out}, 0.5, None, ())
    t_dict["loss"].backward()
    assert set(t_dict) == set(j_dict)
    for key in j_dict:
        np.testing.assert_allclose(t_dict[key].detach().numpy(), np.asarray(j_dict[key]),
                                   rtol=5e-4, atol=1e-5, err_msg=key)

    ref = state_dict_from_flax(j_grads, v["batch_stats"])
    named = dict(tm.named_parameters())
    checked = 0
    for key, param in named.items():
        if not key.startswith("depth_module."):
            assert param.grad is None  # the frozen encoder
            continue
        want = ref[key].numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(param.grad.numpy(), want, rtol=0, atol=1e-3 * scale,
                                   err_msg=key)
        checked += 1
    assert checked == sum(k.startswith("depth_module.") for k in named) > 50


# ----- trainer, checkpoints, config and CLI ----------------------------------


def _config(tmp_path, **trainer):
    with open(CONFIGS / "smoke" / "train_synthetic.json") as f:
        config = json.load(f)
    config["arch"]["args"].update(cv_depth_steps=D, freeze_resnet=True)
    config["data_loader"]["args"].update(length=6, batch_size=2, target_image_size=[H, W],
                                         validation_split=2)
    config["trainer"].update(save_dir=str(tmp_path), log_step=1, len_epoch=2,
                             monitor="min abs_rel_sparse_metric", skip_nonfinite_updates=True,
                             module_timing=False, **trainer)
    return config


def test_trainer_runs_two_steps_and_resumes_from_its_checkpoint(tmp_path):
    config = _config(tmp_path)
    trainer = train_cli.build_trainer(config, "cpu")
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    log = trainer.train()
    assert log["epoch"] == 1 and np.isfinite(log["loss"]) and "val_loss" in log
    lines = [json.loads(s) for s in trainer.log_path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0.0 for r in lines)
    assert {"abs_rel_sparse_metric", "a1_sparse_metric", "sdl_0", "md2l_3"} <= set(lines[0])
    moved = {k for k, p in trainer.model.named_parameters() if not torch.equal(p, before[k])}
    assert moved and all(k.startswith("depth_module.") for k in moved)
    assert any(k.startswith("_feature_extractor.") for k in before)

    ckpt = load_checkpoint(trainer.run_dir / "checkpoint.pth")
    assert set(ckpt) == {"arch", "epoch", "state_dict", "optimizer", "monitor_best", "config"}
    assert ckpt["arch"] == "MonoRec" and ckpt["epoch"] == 1
    assert ckpt["monitor_best"] == log["abs_rel_sparse_metric"]
    assert (trainer.run_dir / "model_best.pth").exists()

    again = train_cli.build_trainer(config, "cpu", run_dir=tmp_path / "again")
    again.resume(trainer.run_dir / "checkpoint.pth")
    assert again.start_epoch == 2 and again.mnt_best == ckpt["monitor_best"]
    for (k, p), q in zip(again.model.state_dict().items(), trainer.model.state_dict().values()):
        assert torch.equal(p, q), k
    steps = {s["step"] for s in again.optimizer.state_dict()["state"].values()}
    assert steps == {2}


def test_cli_trains_from_a_config_file(tmp_path, capsys):
    config = _config(tmp_path, epochs=1)
    config["data_loader"]["args"]["return_stereo"] = True  # for -o stereo
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    assert train_cli.main(["-c", str(path), "--device", "cpu", "--lr", "0.002", "--bs", "2",
                           "-o", "stereo"]) == 0
    out = capsys.readouterr()
    assert "trained 1 epoch(s)" in out.out and "RANDOM" in out.err
    saved = json.loads((tmp_path / "models" / "smoke_synthetic" / "smoke" / "config.json")
                       .read_text())
    assert saved["optimizer"]["args"]["lr"] == 0.002


def test_config_reader_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="NuScenesDataloader"):
        config_mod.build_data_loader({"type": "NuScenesDataloader", "args": {}}, "cpu")
    with pytest.raises(NotImplementedError, match="simple_mask"):
        config_mod.build_model_config({"simple_mask": True})
    with pytest.raises(NotImplementedError, match="imagenet_weights"):
        config_mod.build_model_config({"imagenet_weights": "x.pth"})
    with open(CONFIGS / "train" / "monorec" / "monorec_depth.json") as f:
        arch = json.load(f)["arch"]["args"]
    cfg = config_mod.build_model_config(arch)
    assert (cfg.pretrain_mode, cfg.augmentation, cfg.freeze_resnet) == (1, "depth", True)
    assert cfg.cv_depth_steps == 32 and cfg.pretrain_dropout == 0.0
