"""The stage 2-4 trainer's joint passes through ``MonoRecTrainer._feed`` on
the CPU (``tests/test_torch_joint.py`` holds the grouped cost volume; the two
files run apart).

* ``MonoRecTrainer._feed`` under each joint flag and both, with the flags of
  stage 3 and stage 4 (``tests/test_torch_refinement_feed.py``'s, with each
  stage's real loss) and with ``concat_mono_stereo``: the loss dict, the
  predictions and every parameter's gradient against the port's separate
  passes, and the loss dict and data against JAX ``_feed`` with the same
  flags (draws injected into both, as ``tests/test_torch_monorec_trainer.py``
  does, whose helpers this file uses).

Tolerances: the joint trainer against the separate passes: the JAX package's
own test of the joint decode
(``tests/test_train.py::test_joint_depth_decode_equals_two_pass``), rtol 1e-6
on the loss and rtol 1e-5 / atol 1e-7 on the gradients, the same on the
predictions and the other loss terms (a 2B-batch convolution sums in another
grouping, nothing else differs). Against JAX: the forward budget of
``tests/test_torch_monorec_trainer.py``, rtol 1e-3 / atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.train.monorec_trainer as j_trainer_mod
import test_torch_monorec_trainer as base
import test_torch_refinement_feed as feed
from monorec_tpu.losses import monorec_losses as jl
from monorec_tpu_torch.data.synthetic import batch_to_torch
from monorec_tpu_torch.losses import LOSSES
from test_torch_joint import _spy_groups

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-7  # tests/test_train.py:437


# ----- the trainer ---------------------------------------------------------------------

VARIANTS = {"joint_cv": dict(joint_cv=True), "joint_depth_decode": dict(joint_depth_decode=True),
            "both": dict(joint_cv=True, joint_depth_decode=True)}
# Stage 3's flags with the stereo decode in the batch (its gradient kept)
# and depth_loss, which reads the doubled batch.
CONCAT = (dict(compute_mono_pred=True, compute_stereo_pred=True, concat_mono_stereo=True), {},
          "depth_loss", (), ("att_module.", "depth_module."))


def _port_step(tmp_path, setup, extra: dict):
    """The port's ``_feed`` and backward under the stage ``setup`` and the
    ``extra`` flags: the loss dict, the data and the parameters' gradients."""
    flags, arch, loss, options, _ = setup
    trainer = base._trainer(tmp_path, 0, {**flags, **extra}, 1, augmentation="depth",
                            freeze_module=list(arch.get("freeze_module", ())))
    trainer.loss_fn, trainer.options = LOSSES[loss], options
    trainer.model.train()
    t_dict, t_data = trainer._feed(batch_to_torch(base._batch_cached(1), "cpu"), True, 0.5)
    trainer.optimizer.zero_grad(set_to_none=True)
    t_dict["loss"].backward()
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()
             if p.grad is not None}
    return trainer, t_dict, t_data, grads


def _jax_feed(setup, extra: dict):
    flags, arch, loss, options, _ = setup
    v = base._flax_variables(0)
    ns = base._jax_trainer(0, {**flags, **extra}, augmentation="depth", **arch)
    ns.loss_fn, ns.options = getattr(jl, loss), options
    jb = {k: jnp.asarray(x) for k, x in base._batch_cached(1).items()}
    keys = ("cv_mask", "mono_pred", "stereo_pred", "cost_volume", "cv_uncovered")
    return jax.jit(lambda p: (lambda out: (out[0], {k: out[1][k] for k in keys}))(
        j_trainer_mod.MonoRecTrainer._feed(ns, p, v["batch_stats"], jb, jax.random.PRNGKey(0),
                                           True, 0.5)))(v["params"])


def _close(got, want, key, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol,
                               atol=atol, err_msg=key)


def _check_joint_against_separate(setup, extra, sep, joint):
    (_, s_dict, s_data, s_grads), (_, j_dict, j_data, j_grads) = sep, joint
    assert set(j_dict) == set(s_dict)
    _close(j_dict["loss"], s_dict["loss"], "loss", LOSS_RTOL, 0)
    assert np.isfinite(j_dict["loss"].item())
    for key in s_dict:
        _close(j_dict[key], s_dict[key], key, LOSS_RTOL, GRAD_ATOL)
    if extra.get("joint_cv"):  # the same cost volumes, bit for bit
        for key in ("cost_volume", "single_frame_cvs", "cv_uncovered"):
            assert torch.equal(j_data[key], s_data[key]), key
    for key in ("mono_pred", "stereo_pred"):
        assert len(j_data[key]) == len(s_data[key]) == 4
        for i, (p, r) in enumerate(zip(j_data[key], s_data[key])):
            _close(p, r, f"{key}[{i}]", GRAD_RTOL, GRAD_ATOL)
            assert p.requires_grad == r.requires_grad, f"{key}[{i}]"
    concat = setup[0].get("concat_mono_stereo", False)
    assert all(p.requires_grad == concat for p in j_data["stereo_pred"])
    trained = setup[4]
    assert set(j_grads) == set(s_grads) and all(k.startswith(trained) for k in s_grads)
    assert len(s_grads) > 25
    for key, g in s_grads.items():
        _close(j_grads[key], g, key, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("stage", sorted(feed.STAGES))
def test_joint_feed_equals_separate_passes_and_jax(monkeypatch, tmp_path, stage, variant):
    setup, extra = feed.STAGES[stage], VARIANTS[variant]
    base._patch_flip(monkeypatch, (True, False))
    calls = base._patch_dropout(monkeypatch, base._keep_masks(11))
    seen = _spy_groups(monkeypatch)
    sep = _port_step(tmp_path / "separate", setup, {})
    assert seen == []
    joint = _port_step(tmp_path / "joint", setup, extra)
    assert seen == ([(base.F, 1)] if extra.get("joint_cv") else [])
    _check_joint_against_separate(setup, extra, sep, joint)

    j_dict, j_data = _jax_feed(setup, extra)
    assert calls == {"port": 10, "jax": 5}
    _, t_dict, t_data, _ = joint
    assert set(t_dict) == set(j_dict)
    for key in j_dict:
        base._close(t_dict[key], j_dict[key], key)
    base._close(t_data["cv_mask"], base._nchw(j_data["cv_mask"]), "cv_mask")
    base._close(t_data["cost_volume"], base._nchw(j_data["cost_volume"]), "cost_volume", 0,
                base.CV_ATOL)
    base._close(t_data["cv_uncovered"], j_data["cv_uncovered"], "cv_uncovered", 0, 0)
    for key in ("mono_pred", "stereo_pred"):
        for i, (p, r) in enumerate(zip(t_data[key], j_data[key])):
            base._close(p, base._nchw(r), f"{key}[{i}]")


def test_joint_depth_decode_keeps_the_stereo_gradient_under_concat(monkeypatch, tmp_path):
    """With ``concat_mono_stereo`` the stereo half of the one decode keeps
    its gradient, which the loss on the doubled batch sends back."""
    extra = dict(joint_cv=True, joint_depth_decode=True)
    base._patch_flip(monkeypatch, (True, False))
    base._patch_dropout(monkeypatch, base._keep_masks(12))
    sep = _port_step(tmp_path / "separate", CONCAT, {})
    joint = _port_step(tmp_path / "joint", CONCAT, extra)
    _check_joint_against_separate(CONCAT, extra, sep, joint)
    assert joint[2]["predicted_inverse_depths"][0].shape[0] == 2 * base.B
    j_dict, _ = _jax_feed(CONCAT, extra)
    for key in j_dict:
        base._close(joint[1][key], j_dict[key], key)
