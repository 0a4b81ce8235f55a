"""The port's stage 2-4 protocol against the JAX package on the CPU, at B=2,
32x64, D=4, F=2, on flax weights carried across by ``state_dict_from_flax``:

* the MaskModule's training dropout: its keep rate, its 1 / (1 - p) scale,
  the same draws from the same seed, and the identity in eval;
* the train forward of pretrain modes 0 and 2 against flax's;
* one stage-2 step, ``MonoRecTrainer._feed`` and its gradient, against JAX
  ``MonoRecTrainer._feed`` and ``jax.grad``, with the mask augmentation
  (flip + resized crop through K2's plain version) and the mask loss;
* ``_feed`` under the flags of stage 3 (pretrain mode 0, mono and stereo
  predictions, the depth flip) and stage 4 (``mult_mask_on_cv``,
  ``freeze_module: ["att"]``), with ``mask_loss`` as the loss;
* ``trainer.color_aug_on_device``: both trainers jitter the images of a
  training batch, and only of a training batch (port only).

The two packages draw from different generators, so the tests inject the
same draws into both: the augmentation parameters through each trainer
module's ``sample_mask_aug_params`` / ``sample_flip_conditions``, and the
dropout's keep masks through the port's ``mask_module.dropout_keep`` and
flax's ``random.bernoulli``.

flax initializes conv biases at 0. A layer whose input patch is all zero
(out-of-view cost-volume pixels are exactly 0) then has a pre-activation of
exactly 0, where the LeakyReLU's subgradient differs: torch's (the
reference's and the port's) takes the slope, flax's (``x >= 0``) takes 1
(``test_leaky_relu_subgradient_at_zero_is_torchs``). Both are right, but the
bias gradients of such layers then part beyond the budget below. So the
tests draw every conv bias from a numpy seed (uniform in +-0.05), as any
trained network has them.

Tolerances: the dropout's keep share within 3 sigma of 0.5 on 1e6 draws;
cost volumes atol 2e-4 (``tests/test_torch_slice.py``); ``cv_mask``, the
inverse depths, the loss dict and the MaskModule's gradients rtol 1e-3 /
atol 2e-4 (``tests/test_torch_train.py``'s forward budget), the gradients'
atol scaled by each tensor's largest gradient as that file does; the
cropped images and target atol 1e-5 (``tests/test_torch_mask_aug.py``).
"""

import functools
import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.models.monorec as j_monorec_mod
import monorec_tpu.train.monorec_trainer as j_trainer_mod
import monorec_tpu_torch.models.mask_module as t_mask_mod
import monorec_tpu_torch.models.monorec as t_monorec_mod
import monorec_tpu_torch.train.monorec_trainer as t_trainer_mod
from monorec_tpu.losses.monorec_losses import mask_loss as j_mask_loss
from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu.models.augmentation import MaskAugParams as JMaskAugParams
from monorec_tpu_torch.cli import train_monorec
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.loader import collate
from monorec_tpu_torch.data.synthetic import SyntheticSweepDataset, batch_to_torch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.models.augmentation import MaskAugParams, sample_mask_aug_params
from monorec_tpu_torch.models.mask_module import MaskModule, dropout
from monorec_tpu_torch.models.resnet import ENCODER_CHANNELS

B, H, W, D, F = 2, 32, 64, 4, 2
FUSED_CH = (D, 48, 64, 96, 96)  # the MaskModule's fused features, finest first
RTOL, ATOL, CV_ATOL = 1e-3, 2e-4, 2e-4
_RNGS = {"dropout": jax.random.PRNGKey(1), "augment": jax.random.PRNGKey(2)}


# ----- the dropout -------------------------------------------------------------


def test_dropout_keeps_half_scales_by_two_and_repeats():
    x = torch.ones(1, 1, 1000, 1000)
    out = dropout(x, torch.Generator().manual_seed(4))
    assert set(out.unique().tolist()) == {0.0, 2.0}  # kept values / (1 - 0.5)
    share = (out > 0).float().mean().item()
    assert abs(share - 0.5) < 3 * (0.25 / x.numel()) ** 0.5
    assert torch.equal(out, dropout(x, torch.Generator().manual_seed(4)))
    assert not torch.equal(out, dropout(x, torch.Generator().manual_seed(5)))


def _features(seed: int):
    rng = np.random.default_rng(seed)
    sfcv = torch.from_numpy(rng.uniform(-1, 1, (B, F, D, H, W)).astype(np.float32))
    feats = [torch.from_numpy(rng.uniform(0, 1, (B, c, H >> (i + 1), W >> (i + 1)))
                              .astype(np.float32)) for i, c in enumerate(ENCODER_CHANNELS)]
    return sfcv, feats


def test_mask_module_dropout_acts_in_training_only():
    module = MaskModule(D)
    sfcv, feats = _features(0)
    with torch.no_grad():
        ev = module(sfcv, feats)
        assert torch.equal(ev, module(sfcv, feats, train=False,
                                      generator=torch.Generator().manual_seed(0)))
        tr = [module(sfcv, feats, train=True, generator=torch.Generator().manual_seed(s))
              for s in (0, 0, 1)]
    assert torch.equal(tr[0], tr[1]) and not torch.equal(tr[0], tr[2])
    assert not torch.equal(tr[0], ev)
    with pytest.raises(ValueError, match="generator"):
        module(sfcv, feats, train=True)


# ----- injected draws --------------------------------------------------------------


def _keep_masks(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (B, c, H >> i, W >> i)) < 0.5 for i, c in enumerate(FUSED_CH)]


def _patch_dropout(monkeypatch, masks):
    """Both dropouts take ``masks``, level by level (NCHW; flax gets NHWC)."""
    calls = {"port": 0, "jax": 0}

    def port_keep(shape, keep_prob, generator, device):
        m = masks[calls["port"] % len(masks)]
        calls["port"] += 1
        assert tuple(shape) == m.shape and keep_prob == 0.5
        return torch.from_numpy(m).to(device)

    def jax_bernoulli(key, p=0.5, shape=None):
        m = np.moveaxis(masks[calls["jax"] % len(masks)], 1, -1)
        calls["jax"] += 1
        assert tuple(shape) == m.shape and p == 0.5
        return jnp.asarray(m)

    monkeypatch.setattr(t_mask_mod, "dropout_keep", port_keep)
    monkeypatch.setattr(flax_stochastic, "random", types.SimpleNamespace(bernoulli=jax_bernoulli))
    return calls


def _aug_params():
    p = sample_mask_aug_params(torch.Generator().manual_seed(3), B, H, W)
    return [np.asarray(t) for t in p]


def _patch_mask_aug(monkeypatch, params):
    monkeypatch.setattr(j_trainer_mod, "sample_mask_aug_params",
                        lambda rng, b, h, w: JMaskAugParams(*(jnp.asarray(p) for p in params)))
    monkeypatch.setattr(t_trainer_mod, "sample_mask_aug_params",
                        lambda gen, b, h, w: MaskAugParams(*(torch.from_numpy(p) for p in params)))


def _patch_flip(monkeypatch, cond):
    cond = np.asarray(cond)
    for mod in (j_trainer_mod, j_monorec_mod):
        monkeypatch.setattr(mod, "sample_flip_conditions", lambda rng, b: jnp.asarray(cond))
    for mod in (t_trainer_mod, t_monorec_mod):
        monkeypatch.setattr(mod, "sample_flip_conditions", lambda gen, b: torch.from_numpy(cond))


# ----- models, batches and trainers ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _batch_cached(mvobj: int):
    ds = SyntheticSweepDataset(length=B, target_image_size=(H, W), frame_count=F,
                               return_stereo=True, return_mvobj_mask=mvobj)
    return collate([ds[i] for i in range(B)])


@functools.lru_cache(maxsize=None)
def _flax_variables(mode: int):
    """flax's initial weights, with every conv bias drawn non-zero (see the
    module docstring: flax starts them at 0)."""
    model = JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=mode))
    batch = {k: jnp.asarray(v) for k, v in _batch_cached(2).items()}
    v = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, False))(batch)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(mode)

    def bias(path, leaf):
        is_bias = path[-1].key == "bias" and "BatchNorm_0" not in str(path)
        return rng.uniform(-0.05, 0.05, leaf.shape).astype(np.float32) if is_bias else leaf

    return {"params": jax.tree_util.tree_map_with_path(bias, v["params"]),
            "batch_stats": v["batch_stats"]}


def _nchw(a, lead=1):
    return np.moveaxis(np.asarray(a), -1, lead)


def _jax_trainer(mode: int, flags: dict, **cfg):
    """What JAX ``MonoRecTrainer._feed`` reads of its trainer."""
    ns = types.SimpleNamespace(
        model=JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=mode, **cfg)),
        color_aug_on_device=False, joint_cv=False, joint_depth_decode=False,
        loss_fn=j_mask_loss, roi=None, options=(), compute_mono_pred=True,
        compute_stereo_pred=True, compute_mask=True, mult_mask_on_cv=False,
        concat_mono_stereo=False)
    ns.__dict__.update(flags)
    return ns


def _trainer(tmp_path, mode: int, flags: dict, mvobj: int, **arch):
    """The port's trainer as ``cli/train_monorec.py`` builds it, on the flax
    weights."""
    data = {"length": B, "batch_size": B, "frame_count": F, "target_image_size": [H, W],
            "return_stereo": True, "return_mvobj_mask": mvobj, "shuffle": False}
    config = {
        "name": "stage", "loss": "mask_loss", "metrics": [],
        "arch": {"type": "MonoRecModel",
                 "args": {"pretrain_mode": mode, "cv_depth_steps": D, **arch}},
        "data_loader": {"type": "SyntheticSweepDataloader", "args": data},
        "optimizer": {"type": "Adam", "args": {"lr": 1e-4, "amsgrad": True}},
        "trainer": {"epochs": 1, "save_dir": str(tmp_path), "tensorboard": False, **flags},
    }
    trainer = train_monorec.build_trainer(config, "cpu", run_dir=tmp_path / "run")
    v = _flax_variables(mode)
    trainer.model.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    return trainer


def _close(got, want, key, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=key)


# ----- the train forward of modes 0 and 2 ---------------------------------------


@pytest.mark.parametrize("mode,flip", [(0, (True, False)), (2, (False, True))])
def test_train_forward_with_mask_matches_flax(monkeypatch, mode, flip):
    calls = _patch_dropout(monkeypatch, _keep_masks(mode))
    _patch_flip(monkeypatch, flip)
    jm = JMonoRec(JConfig(cv_depth_steps=D, pretrain_mode=mode, augmentation="depth"))
    tm = MonoRec(MonoRecConfig(cv_depth_steps=D, pretrain_mode=mode, augmentation="depth"))
    v = _flax_variables(mode)
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    nb = _batch_cached(2)
    ref = jax.jit(lambda b: jm.apply(v, b, True, rngs=_RNGS))(
        {k: jnp.asarray(x) for k, x in nb.items()})
    with torch.no_grad():
        out = tm(batch_to_torch(nb, "cpu"), train=True, generator=torch.Generator(),
                 dropout_generator=torch.Generator())
    assert calls == {"port": 5, "jax": 5}
    _close(out["cv_mask"], _nchw(ref["cv_mask"]), "cv_mask")
    _close(out["single_frame_cvs"], _nchw(ref["single_frame_cvs"], 2), "sfcv", 0, CV_ATOL)
    if mode == 0:
        for p, r in zip(out["predicted_inverse_depths"], ref["predicted_inverse_depths"]):
            _close(p, _nchw(r), "predicted_inverse_depths")
    _close(out["result"], _nchw(ref["result"]), "result")


# ----- stage 2: one step against JAX _feed and jax.grad ---------------------------

STAGE2 = dict(compute_mono_pred=False, compute_stereo_pred=False)


def test_stage2_step_matches_jax_feed_and_grad(monkeypatch, tmp_path):
    _patch_mask_aug(monkeypatch, _aug_params())
    calls = _patch_dropout(monkeypatch, _keep_masks(7))
    v = _flax_variables(2)
    ns = _jax_trainer(2, STAGE2, augmentation="mask")
    nb = _batch_cached(2)
    jb = {k: jnp.asarray(x) for k, x in nb.items()}
    keys = ("cv_mask", "target", "keyframe", "frames", "single_frame_cvs", "cost_volume")

    def losses(params):
        loss_dict, data = j_trainer_mod.MonoRecTrainer._feed(
            ns, params, v["batch_stats"], jb, jax.random.PRNGKey(0), True, 0.5)
        return loss_dict["loss"], (loss_dict, {k: data[k] for k in keys})

    (_, (j_dict, j_data)), j_grads = jax.jit(jax.value_and_grad(losses, has_aux=True))(
        v["params"])
    j_grads = jax.tree_util.tree_map(np.asarray, j_grads)

    trainer = _trainer(tmp_path, 2, STAGE2, 2, augmentation="mask")
    trainer.model.train()
    t_dict, t_data = trainer._feed(batch_to_torch(nb, "cpu"), True, 0.5)
    trainer.optimizer.zero_grad(set_to_none=True)
    t_dict["loss"].backward()
    assert calls == {"port": 5, "jax": 5}

    _close(t_data["cv_mask"], _nchw(j_data["cv_mask"]), "cv_mask")
    for key in ("target", "keyframe"):
        _close(t_data[key], _nchw(j_data[key]), key, 0, 1e-5)
    _close(t_data["frames"], _nchw(j_data["frames"], 2), "frames", 0, 1e-5)
    _close(t_data["cost_volume"], _nchw(j_data["cost_volume"]), "cost_volume", 0, CV_ATOL)
    _close(t_data["single_frame_cvs"], _nchw(j_data["single_frame_cvs"], 2), "sfcv", 0, CV_ATOL)
    assert 0 < t_data["target"].sum() < t_data["target"].numel()
    assert set(t_dict) == set(j_dict)
    for key in j_dict:
        _close(t_dict[key], j_dict[key], key)

    ref = state_dict_from_flax(j_grads, v["batch_stats"])
    checked = 0
    for key, param in trainer.model.named_parameters():
        if not key.startswith("att_module."):
            assert param.grad is None, key  # the frozen encoder
            continue
        want = ref[key].numpy()
        _close(param.grad, want, key, RTOL, ATOL * np.abs(want).max())
        checked += 1
    assert checked > 30


# ----- stages 3 and 4: _feed's data dict --------------------------------------------

STAGES = {
    "stage3": (dict(compute_mono_pred=True, compute_stereo_pred=True), {}),
    "stage4": (dict(compute_stereo_pred=True, mult_mask_on_cv=True),
               {"freeze_module": ("att",)}),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_feed_matches_jax_under_later_stage_flags(monkeypatch, tmp_path, stage):
    flags, arch = STAGES[stage]
    _patch_flip(monkeypatch, (True, False))
    calls = _patch_dropout(monkeypatch, _keep_masks(9))
    v = _flax_variables(0)
    ns = _jax_trainer(0, flags, augmentation="depth", **arch)
    nb = _batch_cached(1)
    jb = {k: jnp.asarray(x) for k, x in nb.items()}
    keys = ("cv_mask", "mono_pred", "stereo_pred", "cost_volume")
    j_dict, j_data = jax.jit(lambda p: (lambda out: (out[0], {k: out[1][k] for k in keys}))(
        j_trainer_mod.MonoRecTrainer._feed(ns, p, v["batch_stats"], jb, jax.random.PRNGKey(0),
                                           True, 0.5)))(v["params"])

    trainer = _trainer(tmp_path, 0, flags, 1, augmentation="depth",
                       freeze_module=list(arch.get("freeze_module", ())))
    trainer.model.train()
    t_dict, t_data = trainer._feed(batch_to_torch(nb, "cpu"), True, 0.5)
    assert calls == {"port": 5, "jax": 5}

    _close(t_data["cv_mask"], _nchw(j_data["cv_mask"]), "cv_mask")
    _close(t_data["cost_volume"], _nchw(j_data["cost_volume"]), "cost_volume", 0,
           CV_ATOL)
    for key in ("mono_pred", "stereo_pred"):
        assert len(t_data[key]) == len(j_data[key]) == 4
        for i, (p, r) in enumerate(zip(t_data[key], j_data[key])):
            _close(p, _nchw(r), f"{key}[{i}]")
    assert not any(p.requires_grad for p in t_data["stereo_pred"])  # a detached target
    assert t_data["mono_pred"][0].requires_grad
    assert t_data["cv_mask"].requires_grad == ("att" not in arch.get("freeze_module", ()))
    for key in j_dict:
        _close(t_dict[key], j_dict[key], key)


# ----- the colour jitter, frozen modules, repeatability ------------------------------


@pytest.mark.parametrize("stage", ["stage1", "stage3"])
def test_color_aug_on_device_jitters_training_batches_only(monkeypatch, tmp_path, stage):
    """``trainer.color_aug_on_device`` jitters every image key of a training
    batch before the forward reads it, in the stage-1 trainer and in
    ``MonoRecTrainer``, and leaves validation batches alone."""
    import monorec_tpu_torch.models.augmentation as t_aug
    from monorec_tpu_torch.cli import train as train_cli

    params = t_aug.sample_color_jitter_batch(torch.Generator().manual_seed(4), B)
    monkeypatch.setattr(t_aug, "sample_color_jitter_batch", lambda gen, b: params)
    stage1 = stage == "stage1"
    data = {"length": B, "batch_size": B, "frame_count": F, "target_image_size": [H, W],
            "return_stereo": True, "return_mvobj_mask": 1, "shuffle": False}
    config = {
        "name": stage, "loss": "depth_loss" if stage1 else "mask_loss", "metrics": [],
        "arch": {"type": "MonoRecModel", "args": {"pretrain_mode": 1 if stage1 else 0,
                                                  "cv_depth_steps": D, "augmentation": "depth"}},
        "data_loader": {"type": "SyntheticSweepDataloader", "args": data},
        "optimizer": {"type": "Adam", "args": {"lr": 1e-4}},
        "trainer": {"epochs": 1, "color_aug_on_device": True, "tensorboard": False,
                    **({} if stage1 else STAGES["stage3"][0])},
    }
    build = train_cli.build_trainer if stage1 else train_monorec.build_trainer
    trainer = build(config, "cpu", run_dir=tmp_path / "run")
    seen = []

    def spy(data, *args):
        seen.append({k: data[k].detach().clone() for k in ("keyframe", "frames", "stereoframe")})
        return loss_fn(data, *args)

    loss_fn, trainer.loss_fn = trainer.loss_fn, spy
    batch = batch_to_torch(_batch_cached(1), "cpu")
    trainer.train_step(batch, 0.5)
    trainer.valid_step(batch, 0.5)
    for key in ("keyframe", "frames", "stereoframe"):
        want = t_aug.apply_color_jitter_batch(batch[key], params)
        assert torch.equal(seen[0][key], want), key
        assert not torch.equal(want, batch[key]), key
        assert torch.equal(seen[1][key], batch[key]), key


def test_freeze_module_stops_each_outputs_gradient():
    gen = torch.Generator().manual_seed(0)
    sfcv, feats = _features(1)
    cv = sfcv[:, 0]
    keyframe = torch.zeros(B, 3, H, W)
    for frozen in ((), ("att",), ("depth",)):
        m = MonoRec(MonoRecConfig(cv_depth_steps=D, pretrain_mode=0, freeze_module=frozen),
                    generator=gen)
        mask = m.mask(sfcv, feats)
        preds = m.depth(cv, keyframe, feats)
        assert mask.requires_grad == ("att" not in frozen)
        assert all(p.requires_grad == ("depth" not in frozen) for p in preds)


def test_stage2_steps_repeat_from_the_trainers_seed(tmp_path):
    """Two trainers built alike take the same two stage-2 steps: the crop
    rectangles (CPU generator) and the dropout (device generator, seeded
    from it) repeat. One intra-op thread, so the CPU's sums repeat too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for i in range(2):
            trainer = _trainer(tmp_path / str(i), 2, STAGE2, 2, augmentation="mask")
            batch = batch_to_torch(_batch_cached(2), "cpu")
            losses = [trainer.train_step(batch, 0.5)[0]["loss"] for _ in range(2)]
            runs.append((losses, trainer.model.state_dict()))
    finally:
        torch.set_num_threads(threads)
    (l0, s0), (l1, s1) = runs
    assert l0 == l1 and l0[0] != l0[1]
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_leaky_relu_subgradient_at_zero_is_torchs():
    """At a pre-activation of exactly 0 (a zero input patch, a zero bias) the
    port's LeakyReLU passes the slope 0.1 (torch's rule, the reference's),
    flax's passes 1: the input gradients differ by that factor."""
    from monorec_tpu.models.layers import ConvLReLU as JConvLReLU
    from monorec_tpu_torch.models.layers import ConvLReLU

    x = np.zeros((1, 4, 4, 2), np.float32)
    jconv = JConvLReLU(3, (3, 3))
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))  # flax: zero biases
    j_grad = jax.grad(lambda inp: jconv.apply(v, inp).sum())(jnp.asarray(x))
    kernel = next(a for a in jax.tree_util.tree_leaves(v) if a.ndim == 4)  # (3, 3, I, O)
    conv = ConvLReLU(2, 3, 3)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(np.array(kernel)).permute(3, 2, 0, 1))
        conv.conv.bias.zero_()
    xt = torch.zeros(1, 2, 4, 4, requires_grad=True)
    conv(xt).sum().backward()
    want = 0.1 * np.moveaxis(np.asarray(j_grad), -1, 1)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-7)
