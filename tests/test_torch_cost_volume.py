"""Port cost volume (monorec_tpu_torch.ops) against the JAX package's XLA path
on the same numpy batch, at 32x64, D=8, F=2.

Both port paths run here on the CPU: the sweep path (homographies ->
``plane_sweep_cost_volume``, which on CPU tensors is its plain version
``plane_sweep_sad_reference`` -> ``score_and_fuse``) and the plain path
(projection + ``grid_sample``). The JAX side runs ``backend="xla"``, exact
and of unlimited reach: the reference the Pallas kernel is held to at
atol 1e-4 (tests/test_pallas_kernel.py), the same atol here. The CUDA
kernel itself is checked against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorec_tpu.ops.cost_volume import CostVolumeConfig as JConfig
from monorec_tpu.ops.cost_volume import compute_cost_volume as j_cost_volume
from monorec_tpu.ops.cost_volume import plane_sweep_homographies as j_homographies
from monorec_tpu.ops.sampling import bilinear_sample as j_bilinear_sample
from monorec_tpu.ops.ssim import ssim as j_ssim
from monorec_tpu_torch.data.synthetic import batch_to_torch, make_batch
from monorec_tpu_torch.ops import plane_sweep
from monorec_tpu_torch.ops.cost_volume import CostVolumeConfig, compute_cost_volume
from monorec_tpu_torch.ops.cost_volume import plane_sweep_homographies
from monorec_tpu_torch.ops.sampling import bilinear_sample
from monorec_tpu_torch.ops.ssim import ssim

B, H, W, F, D = 2, 32, 64, 2, 8
INV_MAX, INV_MIN = 0.0025, 0.33  # the model's order: far -> near
_KEYS = ("keyframe", "keyframe_intrinsics", "keyframe_pose", "frames", "intrinsics", "poses")


@functools.lru_cache(maxsize=None)
def _batch(tz):
    return make_batch(B, H, W, F, stereo=False, mask=False, tz=tz)


def _jax_cv(tz, cv_depths=None, **cfg):
    nb = _batch(tz)
    fused, sfcv = j_cost_volume(
        *(jnp.asarray(nb[k]) for k in _KEYS), jnp.float32(INV_MAX), jnp.float32(INV_MIN),
        JConfig(depth_steps=D, **cfg),
        cv_depths=None if cv_depths is None else jnp.asarray(cv_depths),  # (B, D, H, W)
        backend="xla",
    )
    # (B, H, W, D) -> (B, D, H, W); (B, F, H, W, D) -> (B, F, D, H, W)
    return np.moveaxis(np.asarray(fused), -1, 1), np.moveaxis(np.asarray(sfcv), -1, 2)


_jax_cv_cached = functools.lru_cache(maxsize=None)(_jax_cv)


def _port_cv(tz, plain, cv_depths=None, **cfg):
    bt = batch_to_torch(_batch(tz), "cpu")
    fused, sfcv = compute_cost_volume(
        *(bt[k] for k in _KEYS), INV_MAX, INV_MIN, CostVolumeConfig(depth_steps=D, **cfg),
        cv_depths=None if cv_depths is None else torch.from_numpy(cv_depths),
        plain=plain,
    )
    return fused.numpy(), sfcv.numpy()


@pytest.mark.parametrize("tz", [0.0, 0.5])
def test_plane_sweep_homographies_match_jax(tz):
    nb = _batch(tz)
    inv = np.linspace(INV_MAX, INV_MIN, D, dtype=np.float32)
    j = j_homographies(*(jnp.asarray(nb[k]) for k in _KEYS[1:3] + _KEYS[4:]),
                       jnp.asarray(inv), H, W)
    bt = batch_to_torch(nb, "cpu")
    t = plane_sweep_homographies(*(bt[k] for k in _KEYS[1:3] + _KEYS[4:]),
                                 torch.from_numpy(inv), H, W)
    assert t.dtype == torch.float64 and t.shape == (B, F, D, 3, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["sweep", "plain"])
@pytest.mark.parametrize("tz", [0.0, 0.5])
@pytest.mark.parametrize("use_ssim", [1, 2, 0, -1])
def test_cost_volume_matches_jax_xla(use_ssim, tz, path):
    fused_j, sfcv_j = _jax_cv_cached(tz, use_ssim=use_ssim)
    fused, sfcv = _port_cv(tz, plain=path == "plain", use_ssim=use_ssim)
    np.testing.assert_allclose(fused, fused_j, atol=1e-4)
    np.testing.assert_allclose(sfcv, sfcv_j, atol=1e-4)


def test_sfcv_mult_mask_false_matches_jax():
    # The plain path; the warp path (K4) that serves it by default is held
    # to the JAX package in tests/test_torch_warp_sweep.py.
    fused_j, sfcv_j = _jax_cv(0.5, sfcv_mult_mask=False)
    fused, sfcv = _port_cv(0.5, plain=True, sfcv_mult_mask=False)
    np.testing.assert_allclose(fused, fused_j, atol=1e-4)
    np.testing.assert_allclose(sfcv, sfcv_j, atol=1e-4)


def test_cv_depths_override_matches_jax():
    depths = np.random.default_rng(3).uniform(3.0, 400.0, (B, D, H, W)).astype(np.float32)
    fused_j, sfcv_j = _jax_cv(0.0, cv_depths=depths)
    fused, sfcv = _port_cv(0.0, plain=False, cv_depths=depths)
    np.testing.assert_allclose(fused, fused_j, atol=1e-4)
    np.testing.assert_allclose(sfcv, sfcv_j, atol=1e-4)


def _sweep_inputs(tz=0.5):
    bt = batch_to_torch(_batch(tz), "cpu")
    inv = torch.linspace(INV_MAX, INV_MIN, D, dtype=torch.float64)
    homs = plane_sweep_homographies(
        bt["keyframe_intrinsics"], bt["keyframe_pose"], bt["intrinsics"], bt["poses"], inv, H, W
    ).reshape(B * F, D, 3, 3)
    return bt["frames"].reshape(B * F, 3, H, W), bt["keyframe"], homs


def test_plane_sweep_sad_on_cpu_runs_its_plain_version():
    images, keyframes, homs = _sweep_inputs()
    before = plane_sweep.plane_sweep_sad.launches
    out = plane_sweep.plane_sweep_sad(images, keyframes, homs, 2, F, 1)
    ref = plane_sweep.plane_sweep_sad_reference(images, keyframes, homs, 2, F, 1)
    assert len(out) == len(ref) == 2
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[0].shape == out[1].shape == (B * F, D, H, W)
    assert plane_sweep.plane_sweep_sad.launches == before  # no kernel launch on CPU


@functools.lru_cache(maxsize=None)
def _batch_f(f):
    return make_batch(B, H, W, f, stereo=False, mask=False, tz=0.5)


@pytest.mark.parametrize("not_center_cv", [False, True])
@pytest.mark.parametrize("use_ssim", [1, 2, 0, -1])
@pytest.mark.parametrize("f", [1, 2])
def test_plane_sweep_cost_volume_reference_matches_jax_xla(f, use_ssim, not_center_cv):
    # The plain version of K1's cost-volume mode (the kernel's SADs, validity
    # and score_and_fuse) against the JAX XLA cost volume, _score_and_fuse
    # included, at the atol the Pallas kernel is held to.
    nb = _batch_f(f)
    fused_j, sfcv_j = j_cost_volume(
        *(jnp.asarray(nb[k]) for k in _KEYS), jnp.float32(INV_MAX), jnp.float32(INV_MIN),
        JConfig(depth_steps=D, use_ssim=use_ssim, not_center_cv=not_center_cv), backend="xla",
    )
    bt = batch_to_torch(nb, "cpu")
    inv = torch.linspace(INV_MAX, INV_MIN, D, dtype=torch.float64)
    homs = plane_sweep_homographies(
        bt["keyframe_intrinsics"], bt["keyframe_pose"], bt["intrinsics"], bt["poses"], inv, H, W
    ).reshape(B * f, D, 3, 3)
    fused, sfcv = plane_sweep.plane_sweep_cost_volume_reference(
        bt["frames"].reshape(B * f, 3, H, W), bt["keyframe"], homs, 2, f, use_ssim,
        plane_sweep.DEFAULT_CHANNEL_WEIGHTS, 10.0, not_center_cv,
    )
    assert fused.shape == (B, D, H, W) and sfcv.shape == (B, f, D, H, W)
    np.testing.assert_allclose(fused.numpy(), np.moveaxis(np.asarray(fused_j), -1, 1), atol=1e-4)
    np.testing.assert_allclose(sfcv.numpy(), np.moveaxis(np.asarray(sfcv_j), -1, 2), atol=1e-4)


def test_plane_sweep_cost_volume_on_cpu_runs_its_plain_version():
    images, keyframes, homs = _sweep_inputs()
    fn = plane_sweep.plane_sweep_cost_volume
    before = fn.launches, fn.launches_bf16
    out = fn(images, keyframes, homs, 2, F, 2, not_center_cv=True)
    ref = plane_sweep.plane_sweep_cost_volume_reference(images, keyframes, homs, 2, F, 2,
                                                        not_center_cv=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (fn.launches, fn.launches_bf16) == before  # no kernel launch on CPU


@pytest.mark.parametrize("bad", ["device", "keyframes", "mode"])
def test_plane_sweep_cost_volume_rejects_what_the_kernel_cannot_take(bad):
    images, keyframes, homs = _sweep_inputs()
    kwargs = dict(frames_per_image=F, use_ssim=1)
    if bad == "device":  # neither CPU nor CUDA
        images, keyframes, homs = (t.to("meta") for t in (images, keyframes, homs))
        call = plane_sweep.plane_sweep_cost_volume
    else:  # the checks the wrapper runs on CUDA tensors
        call = lambda *a, **k: plane_sweep._check_kernel_inputs(  # noqa: E731
            *a, channel_weights=plane_sweep.DEFAULT_CHANNEL_WEIGHTS, **k)
        if bad == "keyframes":
            kwargs["frames_per_image"] = 3  # 4 sources are not 3 frames per keyframe
        else:
            kwargs["use_ssim"] = 3
    with pytest.raises((TypeError, ValueError)):
        call(images, keyframes, homs, **kwargs)


@pytest.mark.parametrize("bad", ["float32_homographies", "keyframes", "channels", "mode"])
def test_kernel_input_checks_raise(bad):
    images, keyframes, homs = _sweep_inputs()
    kwargs = dict(frames_per_image=F, use_ssim=1,
                  channel_weights=plane_sweep.DEFAULT_CHANNEL_WEIGHTS)
    if bad == "float32_homographies":
        homs = homs.float()
    elif bad == "keyframes":
        keyframes = keyframes[:1]
    elif bad == "channels":
        images, keyframes = images[:, :2].contiguous(), keyframes[:, :2].contiguous()
    else:
        kwargs["use_ssim"] = 3
    with pytest.raises((TypeError, ValueError)):
        plane_sweep._check_kernel_inputs(images, keyframes, homs, **kwargs)


@pytest.mark.parametrize("comp_mode", [False, True])
@pytest.mark.parametrize("gaussian_average", [False, True])
@pytest.mark.parametrize("pad_reflection", [True, False])
def test_ssim_matches_jax(pad_reflection, gaussian_average, comp_mode):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 3, 12, 17)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 3, 12, 17)).astype(np.float32)
    kw = dict(pad_reflection=pad_reflection, gaussian_average=gaussian_average,
              comp_mode=comp_mode)
    j = j_ssim(jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(np.moveaxis(y, 1, -1)), **kw)
    t = ssim(torch.from_numpy(x), torch.from_numpy(y), **kw)
    np.testing.assert_allclose(t.numpy(), np.moveaxis(np.asarray(j), -1, 1), atol=1e-5)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.5, 0.5, (10, 14, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (7, 9, 2)).astype(np.float32)  # some taps out of range
    j = j_bilinear_sample(jnp.asarray(img), jnp.asarray(grid))
    t = bilinear_sample(torch.from_numpy(img).permute(2, 0, 1)[None], torch.from_numpy(grid)[None])
    np.testing.assert_allclose(t[0].permute(1, 2, 0).numpy(), np.asarray(j), atol=1e-5)
