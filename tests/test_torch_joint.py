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
* ``MonoRecTrainer._feed`` under the joint flags: ``tests/
  test_torch_joint_feed.py``.

Tolerances: the port's pair against its separate calls atol 0 (per-frame
work never mixes frames, and the CPU's sums run in the same order); against
JAX atol 1e-4, ``tests/test_torch_cost_volume.py``'s budget.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monorec_tpu_torch.ops.cost_volume as t_cv_mod
from monorec_tpu.ops.cost_volume import CostVolumeConfig as JConfig
from monorec_tpu.ops.cost_volume import compute_cost_volume_pair as j_pair
from monorec_tpu_torch.ops import plane_sweep
from monorec_tpu_torch.ops.cost_volume import (
    CostVolumeConfig,
    compute_cost_volume,
    compute_cost_volume_pair,
)

B, H, W, D, F = 2, 32, 128, 4, 2
INV_MAX, INV_MIN = 0.0025, 0.33  # the model's order: far -> near
CV_ATOL = 1e-4  # tests/test_torch_cost_volume.py
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
                            INV_MIN, cfg, **kwargs)
    s = compute_cost_volume(*key, bt["stereoframe"][:, None],
                            bt["stereoframe_intrinsics"][:, None], bt["stereoframe_pose"][:, None],
                            INV_MAX, INV_MIN, cfg, **kwargs)
    return (*m, *s)


def _assert_equal_outputs(got, want):
    assert len(got) == len(want) == 4
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
                                             (B, 1, D, H, W)]
    # JAX: fused (B, H, W, D), per-frame (B, F, H, W, D), then its coverage.
    want = [np.moveaxis(np.asarray(j_out[i]), -1, 1 if i % 2 == 0 else 2) for i in range(4)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=CV_ATOL, err_msg=str(i))
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
