"""The stage 2-4 trainer's joint passes on the CPU: ``trainer.joint_cv`` (the
mono and the stereo cost volume from one grouped launch of K1,
``compute_cost_volume_pair``) and ``trainer.joint_depth_decode`` (one
DepthModule pass over the 2B samples), against the port's separate passes
and the JAX package.

* ``compute_cost_volume_pair`` at 32x128, D=4, F=2 + the stereo frame, on
  numpy-seeded images and poses: against JAX ``compute_cost_volume_pair``
  with its Pallas kernel in interpret mode (as
  ``tests/test_pallas_kernel.py::test_cost_volume_pair_matches_separate_sweeps``
  runs it), and exactly against the port's two ``compute_cost_volume``
  calls; it routes one grouped call of K1's wrapper, and none where the
  sweep path does not serve (the K4 warp path, the plain path, a
  ``cv_depths`` override), where it is the two calls;
* K1's grouped plain version, float32 and bf16 sources, exactly against a
  call per group;
* ``MonoRecTrainer._feed`` under each joint flag and both, with the flags of
  stage 3 and stage 4 (``tests/test_torch_refinement_feed.py``'s, with each
  stage's real loss) and with ``concat_mono_stereo``: the loss dict, the
  predictions and every parameter's gradient against the port's separate
  passes, and the loss dict and data against JAX ``_feed`` with the same
  flags (draws injected into both, as ``tests/test_torch_monorec_trainer.py``
  does, whose helpers this file uses).

Tolerances: the port's pair against its separate calls atol 0 (per-frame
work never mixes frames, and the CPU's sums run in the same order); against
JAX atol 1e-4, ``tests/test_torch_cost_volume.py``'s budget. The joint
trainer against the separate passes: the JAX package's own test of the joint
decode (``tests/test_train.py::test_joint_depth_decode_equals_two_pass``),
rtol 1e-6 on the loss and rtol 1e-5 / atol 1e-7 on the gradients, the same
on the predictions and the other loss terms (a 2B-batch convolution sums in
another grouping, nothing else differs). Against JAX: the forward budget of
``tests/test_torch_monorec_trainer.py``, rtol 1e-3 / atol 2e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu.train.monorec_trainer as j_trainer_mod
import monorec_tpu_torch.ops.cost_volume as t_cv_mod
import test_torch_monorec_trainer as base
import test_torch_refinement_feed as feed
from monorec_tpu.losses import monorec_losses as jl
from monorec_tpu.ops.cost_volume import CostVolumeConfig as JConfig
from monorec_tpu.ops.cost_volume import compute_cost_volume_pair as j_pair
from monorec_tpu_torch.data.synthetic import batch_to_torch
from monorec_tpu_torch.losses import LOSSES
from monorec_tpu_torch.ops import plane_sweep
from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    compute_cost_volume_pair,
)

B, H, W, D, F = 2, 32, 128, 4, 2
INV_MAX, INV_MIN = 0.0025, 0.33  # the model's order: far -> near
CV_ATOL = 1e-4  # tests/test_torch_cost_volume.py
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-7  # tests/test_train.py:437
_PAIR_KEYS = ("keyframe", "keyframe_intrinsics", "keyframe_pose", "frames", "intrinsics",
              "poses", "stereoframe", "stereoframe_intrinsics", "stereoframe_pose")


# ----- the grouped cost volume ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair_inputs():
    """NHWC numpy inputs (the JAX layout): random images, a pinhole camera,
    mono frames displaced sideways and forward, a stereo frame 0.54 m to the
    side (KITTI's baseline)."""
    rng = np.random.default_rng(0)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = k[1, 1] = 0.8 * W
    k[0, 2], k[1, 2] = W / 2 - 0.5, H / 2 - 0.5
    k[2, 2] = k[3, 3] = 1.0
    kb = np.tile(k, (B, 1, 1))
    eye = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, F, 1, 1))
    for i in range(F):
        poses[:, i, 0, 3] = 0.3 * (i - F / 2 + 0.5)
        poses[:, i, 2, 3] = 0.4 * (i + 1)
    stereo_pose = eye.copy()
    stereo_pose[:, 0, 3] = 0.54
    image = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)  # noqa: E731
    return dict(keyframe=image(B, H, W, 3), keyframe_intrinsics=kb, keyframe_pose=eye,
                frames=image(B, F, H, W, 3), intrinsics=np.tile(kb[:, None], (1, F, 1, 1)),
                poses=poses, stereoframe=image(B, H, W, 3), stereoframe_intrinsics=kb,
                stereoframe_pose=stereo_pose)


def _port_inputs():
    nb = _pair_inputs()
    out = {k: torch.tensor(v) for k, v in nb.items()}
    for key, axis in (("keyframe", 1), ("frames", 2), ("stereoframe", 1)):
        out[key] = torch.tensor(np.moveaxis(nb[key], -1, axis)).contiguous()
    return out


def _spy_groups(monkeypatch) -> list:
    """The ``groups`` of every grouped call of K1's wrapper by the cost volume."""
    seen = []

    def spy(*args, groups=None, **kwargs):
        if groups is not None:
            seen.append(tuple(groups))
        return plane_sweep.plane_sweep_cost_volume(*args, groups=groups, **kwargs)

    monkeypatch.setattr(t_cv_mod, "plane_sweep_cost_volume", spy)
    return seen


def _separate(bt, cfg, **kwargs):
    """The two ``compute_cost_volume`` calls the pair stands for."""
    key = [bt[k] for k in _PAIR_KEYS[:3]]
    m = compute_cost_volume(*key, bt["frames"], bt["intrinsics"], bt["poses"], INV_MAX,
                            INV_MIN, cfg, return_coverage=True, **kwargs)
    s = compute_cost_volume(*key, bt["stereoframe"][:, None],
                            bt["stereoframe_intrinsics"][:, None], bt["stereoframe_pose"][:, None],
                            INV_MAX, INV_MIN, cfg, return_coverage=True, **kwargs)
    return m[0], m[1], s[0], s[1], m[2] + s[2]


def _assert_equal_outputs(got, want):
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), i


@pytest.mark.parametrize("use_ssim", [1, 2])
def test_cost_volume_pair_matches_jax_kernel_and_separate_calls(monkeypatch, use_ssim):
    nb = _pair_inputs()
    j_out = j_pair(*(jnp.asarray(nb[k]) for k in _PAIR_KEYS), jnp.float32(INV_MAX),
                   jnp.float32(INV_MIN), JConfig(depth_steps=D, use_ssim=use_ssim),
                   backend="pallas", interpret=True)
    seen = _spy_groups(monkeypatch)
    bt = _port_inputs()
    cfg = CostVolumeConfig(depth_steps=D, use_ssim=use_ssim)
    got = compute_cost_volume_pair(*(bt[k] for k in _PAIR_KEYS), INV_MAX, INV_MIN, cfg)
    assert seen == [(F, 1)]
    assert [tuple(t.shape) for t in got] == [(B, D, H, W), (B, F, D, H, W), (B, D, H, W),
                                             (B, 1, D, H, W), (B,)]
    # JAX: fused (B, H, W, D), per-frame (B, F, H, W, D), coverage (B,).
    want = [np.moveaxis(np.asarray(j_out[i]), -1, 1 if i % 2 == 0 else 2) for i in range(4)]
    for i, (g, w) in enumerate(zip(got[:4], want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=CV_ATOL, err_msg=str(i))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(j_out[4]))
    _assert_equal_outputs(got, _separate(bt, cfg))


@pytest.mark.parametrize("case", ["sfcv_mult_mask", "plain", "cv_depths"])
def test_cost_volume_pair_falls_back_to_two_calls(monkeypatch, case):
    """Where the sweep path does not serve, the pair is the two calls (the
    K4 warp path, the plain path, the plain path under a per-pixel depth
    override), as JAX's two XLA calls are."""
    bt = _port_inputs()
    nb = _pair_inputs()
    cfg, jcfg, kwargs, jkwargs = CostVolumeConfig(depth_steps=D), JConfig(depth_steps=D), {}, {}
    if case == "sfcv_mult_mask":
        cfg, jcfg = (CostVolumeConfig(depth_steps=D, sfcv_mult_mask=False),
                     JConfig(depth_steps=D, sfcv_mult_mask=False))
    elif case == "plain":
        kwargs["plain"] = True
    else:
        depths = np.random.default_rng(1).uniform(3.0, 60.0, (B, D, H, W)).astype(np.float32)
        kwargs["cv_depths"], jkwargs["cv_depths"] = torch.from_numpy(depths), jnp.asarray(depths)
    seen = _spy_groups(monkeypatch)
    got = compute_cost_volume_pair(*(bt[k] for k in _PAIR_KEYS), INV_MAX, INV_MIN, cfg,
                                   **kwargs)
    assert seen == []
    _assert_equal_outputs(got, _separate(bt, cfg, **kwargs))
    j_out = j_pair(*(jnp.asarray(nb[k]) for k in _PAIR_KEYS), jnp.float32(INV_MAX),
                   jnp.float32(INV_MIN), jcfg, backend="xla", **jkwargs)
    for i in range(4):
        want = np.moveaxis(np.asarray(j_out[i]), -1, 1 if i % 2 == 0 else 2)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=CV_ATOL, err_msg=str(i))


def test_cost_volume_pair_on_bf16_sources_equals_separate_calls(monkeypatch):
    """The serving policy's bf16 sources through the grouped sweep."""
    seen = _spy_groups(monkeypatch)
    bt = _port_inputs()
    cfg = CostVolumeConfig(depth_steps=D, warp_dtype="bfloat16")
    got = compute_cost_volume_pair(*(bt[k] for k in _PAIR_KEYS), INV_MAX, INV_MIN, cfg)
    assert seen == [(F, 1)]
    _assert_equal_outputs(got, _separate(bt, cfg))


def _sweep_inputs(frames: int, dtype):
    """K1's inputs for ``frames`` sources per keyframe: the pair's mono and
    stereo frames, cut or repeated to ``frames``."""
    bt = _port_inputs()
    src = torch.cat([bt["frames"], bt["stereoframe"][:, None]], 1)
    intr = torch.cat([bt["intrinsics"], bt["stereoframe_intrinsics"][:, None]], 1)
    poses = torch.cat([bt["poses"], bt["stereoframe_pose"][:, None]], 1)
    idx = torch.arange(frames) % (F + 1)
    inv = torch.linspace(INV_MAX, INV_MIN, D, dtype=torch.float64)
    homs = t_cv_mod.plane_sweep_homographies(bt["keyframe_intrinsics"], bt["keyframe_pose"],
                                             intr[:, idx], poses[:, idx], inv, H, W)
    images = src[:, idx].reshape(B * frames, 3, H, W).to(dtype)
    return images, bt["keyframe"], homs.reshape(B * frames, D, 3, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [(2, 1), (1, 2), (1, 1, 1), (3,), (2, 2)])
def test_grouped_plain_version_equals_a_call_per_group(dtype, groups):
    f = sum(groups)
    images, keyframes, homs = _sweep_inputs(f, dtype)
    args = (2, f, 1, plane_sweep.DEFAULT_CHANNEL_WEIGHTS, 10.0, False)
    outs = plane_sweep.plane_sweep_cost_volume(images, keyframes, homs, *args, groups=groups)
    assert len(outs) == len(groups)
    per_key = lambda t, g: t.reshape((B, f) + t.shape[1:])[:, g].flatten(0, 1)  # noqa: E731
    f0 = 0
    for (fused, sfcv), fg in zip(outs, groups):
        g = slice(f0, f0 + fg)
        want = plane_sweep.plane_sweep_cost_volume(per_key(images, g), keyframes,
                                                   per_key(homs, g), 2, fg, 1)
        assert fused.shape == (B, D, H, W) and sfcv.shape == (B, fg, D, H, W)
        assert torch.equal(fused, want[0]) and torch.equal(sfcv, want[1])
        f0 += fg
    whole = plane_sweep.plane_sweep_cost_volume(images, keyframes, homs, *args)
    single = plane_sweep.plane_sweep_cost_volume(images, keyframes, homs, *args, groups=(f,))
    assert len(single) == 1 and all(torch.equal(a, b) for a, b in zip(whole, single[0]))


@pytest.mark.parametrize("groups", [(2, 2), (0, 3), (), (3, 1)])
def test_groups_that_do_not_partition_the_frames_raise(groups):
    images, keyframes, homs = _sweep_inputs(3, torch.float32)
    with pytest.raises(ValueError, match="partition"):
        plane_sweep.plane_sweep_cost_volume(images, keyframes, homs, 2, 3, 1, groups=groups)


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
